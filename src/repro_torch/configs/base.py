"""Model configuration schema shared by all 10 assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    dense_residual_ff: int = 0   # arctic: parallel dense FFN
    every: int = 1               # MoE layer cadence (jamba: 2)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    attn: str = "gqa"            # gqa | mla | none
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    pos: str = "rope"            # rope | mrope | learned | none
    rope_pct: float = 1.0        # partial rotary (stablelm: 0.25)
    rope_theta: float = 10000.0
    mlp: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    bias: bool = False
    # hybrid (jamba): one attention layer per `attn_every`, mamba otherwise
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # xLSTM: one sLSTM per `slstm_every` blocks, mLSTM otherwise
    slstm_every: int = 0
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"       # vision | audio | none — STUB embeddings
    tie_embeddings: bool = True
    sliding_window: int = 0      # long-context attention window (hybrid)
    dtype: str = "bfloat16"
    # distribution hints
    fsdp: bool = False           # shard params over the data axis too
    optimizer_state_dtype: str = "float32"  # bf16 for >=100B models
    # perf-iteration knobs (EXPERIMENTS.md §Perf)
    ce_impl: str = "gather"      # gather (logsumexp) | softmax (full array)
    expert_shard: str = "dmodel"  # FSDP axis on experts: dmodel | ff

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS accounting)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        for i in range(L):
            is_attn = (self.attn_every == 0 or
                       (i % self.attn_every == self.attn_every - 1))
            if self.family == "ssm":
                di = self.mamba_expand * d
                per += 2 * d * 2 * di + 2 * di * d  # up/gate + mlstm + down
                continue
            if is_attn and self.attn != "none":
                if self.attn == "mla" and self.mla:
                    m = self.mla
                    per += d * m.q_lora_rank + m.q_lora_rank * self.n_heads \
                        * (m.qk_nope_dim + m.qk_rope_dim)
                    per += d * (m.kv_lora_rank + m.qk_rope_dim)
                    per += m.kv_lora_rank * self.n_heads \
                        * (m.qk_nope_dim + m.v_head_dim)
                    per += self.n_heads * m.v_head_dim * d
                else:
                    per += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                    per += self.n_heads * self.hd * d
            elif self.attn_every:
                di = self.mamba_expand * d
                per += d * 2 * di + di * d + di * self.mamba_d_state * 2
            if self.moe and (i % self.moe.every == 0):
                per += self.moe.n_experts * 3 * d * self.moe.d_expert_ff
                per += self.moe.n_experts * d  # router
                if self.moe.dense_residual_ff:
                    per += 3 * d * self.moe.dense_residual_ff
            elif self.d_ff:
                mult = 3 if self.mlp == "swiglu" else 2
                per += mult * d * self.d_ff
        enc = 0
        if self.enc_dec:
            enc = self.n_enc_layers * (
                4 * d * d + (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
            ) + L * 4 * d * d  # cross-attention in decoder
        return emb + per + enc


def n_active_params(cfg: ModelConfig) -> int:
    """Active (per-token) params for MoE — drives 6*N_active*D."""
    if not cfg.moe:
        return cfg.n_params()
    full = cfg.n_params()
    moe_layers = sum(1 for i in range(cfg.n_layers)
                     if i % cfg.moe.every == 0)
    expert_params = moe_layers * cfg.moe.n_experts * 3 * cfg.d_model \
        * cfg.moe.d_expert_ff
    active_expert = moe_layers * cfg.moe.top_k * 3 * cfg.d_model \
        * cfg.moe.d_expert_ff
    return full - expert_params + active_expert
