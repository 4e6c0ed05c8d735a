"""Model configuration and the dense KV cache (port of
``tensorlink_tpu/models/base.py``).

The same fields and defaults as the JAX :class:`ModelConfig`, so a config
moves between the packages field for field; only ``dtype`` is a
``torch.dtype`` here. :class:`KVCache` is the dense cache of
``engine/generate.py::GenerationEngine``; continuous serving uses the
paged cache (``engine/paged.py``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace

import torch

from ..core.devices import resolve_device

# dtype names as the JAX package writes them in a config's JSON
# (``jnp.dtype(...).name``), so one JSON config moves between packages
# tlint: disable=TL006(read-only constant table)
DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a torch dtype (``torch.bfloat16`` →
    ``"bfloat16"``); raises for a dtype outside :data:`DTYPES`."""
    for name, dt in DTYPES.items():
        if dt == dtype:
            return name
    raise TypeError(f"no dtype name for {dtype!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the decoder-only core.

    - ``pos="learned"``, ``mlp="fused"``, ``norm="layernorm"`` → GPT-2.
    - ``pos="rope"``, ``mlp="gated"``, ``norm="rmsnorm"`` → Llama-family.
    - ``qk_norm=True`` → Qwen3.
    - ``embed_scale`` + ``norm_plus_one`` → Gemma.
    - ``parallel_residual`` + ``rope_pct<1`` + layernorm → GPT-NeoX/Pythia.
    - ``norm_position="post"`` + ``qk_norm_full`` → OLMo-2.
    - ``n_experts>0`` → Mixtral MoE (top-k expert MLP).
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

    def to_json(self) -> dict:
        """JSON-safe dict (job specs carry the config over the wire);
        ``dtype`` under the JAX package's name, so the dict equals the
        JAX config's ``to_json`` field for field."""
        d = asdict(self)
        d["dtype"] = dtype_name(self.dtype)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        if isinstance(d.get("dtype"), str):
            try:
                d["dtype"] = DTYPES[d["dtype"]]
            except KeyError:
                raise TypeError(f"unknown dtype {d['dtype']!r}") from None
        return cls(**d)

    def param_count(self) -> int:
        """Analytic parameter count (the sharding planner's memory
        estimate; ``engine/loader.py::estimate_params_bytes``)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.moe:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        elif self.mlp == "gated":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        norms = 2 * d * (2 if self.norm == "layernorm" else 1)
        emb = v * d + (0 if self.tie_embeddings else v * d)
        pos = self.max_seq_len * d if self.pos == "learned" else 0
        return L * (attn + mlp + norms) + emb + pos + d


@dataclass
class KVCache:
    """Dense decode cache: ``k``/``v`` are ``[L, B, S_max, n_kv, hd]``,
    ``length`` the valid positions per batch row, int32 ``[B]``, all on
    one device.

    int8 mode (``quantized``): ``k``/``v`` hold int8 codes with f32
    per-(layer, row, position, head) scales ``k_scale``/``v_scale``
    ``[L, B, S_max, n_kv, 1]``; attention dequantizes on read, and each
    write quantizes its rows (``models/transformer.py::_block``).

    The JAX cache is donated to each compiled step; here ``forward``
    writes ``k``/``v`` (and the scales) in place and returns a cache
    holding the same tensors with a fresh ``length``."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # int32 [B]
    k_scale: torch.Tensor | None = None  # f32, present in int8 mode
    v_scale: torch.Tensor | None = None

    @classmethod
    def init(
        cls,
        cfg: ModelConfig,
        batch: int,
        max_len: int | None = None,
        dtype: torch.dtype | None = None,
        quantized: bool = False,
        device=None,
    ) -> "KVCache":
        """A zeroed cache of ``batch`` rows and ``max_len`` positions on
        ``device`` (None = the CUDA card): ``dtype`` payload, or int8
        codes with zeroed f32 scales when ``quantized``."""
        dev = resolve_device(device)
        S = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if quantized:
            sshape = shape[:-1] + (1,)
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                length=length,
                k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            )
        dt = dtype or cfg.dtype
        return cls(
            k=torch.zeros(shape, dtype=dt, device=dev),
            v=torch.zeros(shape, dtype=dt, device=dev),
            length=length,
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer_kv(self, i: int) -> tuple:
        """Layer ``i``'s views: ``(k, v)``, or ``(k, v, k_scale, v_scale)``
        in int8 mode — the arity ``_block`` branches on."""
        if self.k_scale is None:
            return (self.k[i], self.v[i])
        return (self.k[i], self.v[i], self.k_scale[i], self.v_scale[i])

    def take(self, idx: torch.Tensor) -> "KVCache":
        """A new cache of the batch rows ``idx`` (copies): the beam
        search's tile and reorder, and the chunked decode's shrink."""
        idx = idx.to(self.k.device)

        def rows(t):
            return None if t is None else t[:, idx]

        return KVCache(k=rows(self.k), v=rows(self.v),
                       length=self.length[idx], k_scale=rows(self.k_scale),
                       v_scale=rows(self.v_scale))


__all__ = ["DTYPES", "KVCache", "ModelConfig", "dtype_name"]
