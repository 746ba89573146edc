"""The port's dry run on a small simulated mesh for the hybrid (jamba),
xLSTM, M-RoPE VLM (qwen2-vl) and encoder-decoder (whisper) families:
a REDUCED train step and decode step each, in one subprocess on a
``fake`` group of 8 ranks (``test_torch_dryrun_small.py`` runs the
dense, MLA and MoE families and says what each cell must show).
"""
import pytest

pytest.importorskip("torch")

from test_torch_dryrun_small import check_family, run_cells  # noqa: E402

FAMILIES = ["jamba_1_5_large_398b", "xlstm_1_3b", "qwen2_vl_2b",
            "whisper_base"]


@pytest.fixture(scope="module")
def cells():
    return run_cells(*FAMILIES)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_and_decode(cells, arch):
    check_family(cells[arch])
