"""The port's ``loss_fn``, its gradients and ``make_train_step`` against
the JAX package's for the recurrent and multimodal families at their
``REDUCED`` configs: the Mamba + attention hybrid with MoE
(jamba-1.5-large), xLSTM (mLSTM and sLSTM), the M-RoPE VLM (qwen2-vl-2b,
three position streams and stub patch embeddings) and the
encoder-decoder (whisper-base, stub frames).

As ``test_torch_train_steps_dense_moe.py`` (whose helpers and
tolerances this file shares): float32 gradients at 1e-4 x each leaf's
scale and the loss within 1e-5; bf16 at qwen2-vl at 0.05 and 0.01.
Backward, the port's Mamba prefill runs its sequential float32 loop
where the reference differentiates an associative scan: equal within
float32 rounding.  One ``make_train_step`` step at jamba's REDUCED
config with bf16 moments, the optimizer state dtype of jamba's full
config, held within one bf16 ulp more.
"""
import pytest

from repro_torch.configs import get_config
from test_torch_train_steps_dense_moe import (  # noqa: E402
    check_loss_and_grads, check_train_step,
)

ARCHS = ["jamba_1_5_large_398b", "xlstm_1_3b", "qwen2_vl_2b", "whisper_base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32(arch):
    check_loss_and_grads(arch, "float32")


def test_loss_and_grads_bf16():
    check_loss_and_grads("qwen2_vl_2b", "bfloat16")


def test_train_step_hybrid_bf16_moments():
    arch = "jamba_1_5_large_398b"
    assert get_config(arch).optimizer_state_dtype == "bfloat16"
    check_train_step(arch, state_dtype="bfloat16")
