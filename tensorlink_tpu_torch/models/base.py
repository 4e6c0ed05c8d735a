"""Model configuration (port of ``tensorlink_tpu/models/base.py``).

The same fields and defaults as the JAX :class:`ModelConfig`, so a config
moves between the packages field for field; only ``dtype`` is a
``torch.dtype`` here. The dense ``KVCache`` stays with the dense
``GenerationEngine`` slice; serving uses the paged cache
(``engine/paged.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the decoder-only core.

    - ``pos="learned"``, ``mlp="fused"``, ``norm="layernorm"`` → GPT-2.
    - ``pos="rope"``, ``mlp="gated"``, ``norm="rmsnorm"`` → Llama-family.
    - ``qk_norm=True`` → Qwen3.
    - ``embed_scale`` + ``norm_plus_one`` → Gemma.
    - ``parallel_residual`` + ``rope_pct<1`` + layernorm → GPT-NeoX/Pythia.
    - ``norm_position="post"`` + ``qk_norm_full`` → OLMo-2.
    - ``n_experts>0`` → Mixtral MoE (not ported yet: ``init_params`` and
      the MLP raise).
    """

    family: str = "llama"
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    d_ff: int = 11008
    max_seq_len: int = 4096
    norm_eps: float = 1e-6
    act: str = "silu"  # "silu" | "gelu" (tanh approx) | "gelu_exact" (erf)
    pos: str = "rope"  # "rope" | "learned"
    rope_theta: float = 10000.0
    rope_pct: float = 1.0
    attn_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    mlp: str = "gated"  # "gated" (gate*up) | "fused" (up->act->down)
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_plus_one: bool = False
    qk_norm: bool = False
    qk_norm_full: bool = False
    norm_position: str = "pre"
    embed_scale: bool = False
    parallel_residual: bool = False
    tie_embeddings: bool = False
    attn_scale: float | None = None  # None → 1/sqrt(head_dim)
    n_experts: int = 0
    n_experts_per_tok: int = 2
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 2.0
    moe_group_size: int = 1024
    sliding_window: int | None = None
    dtype: torch.dtype = torch.bfloat16
    logit_cap: float | None = None
    flash_attention: bool = False
    collective_quant: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


__all__ = ["ModelConfig"]
