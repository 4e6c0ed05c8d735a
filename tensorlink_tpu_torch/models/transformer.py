"""Decoder building blocks and the dense forward (port of
``tensorlink_tpu/models/transformer.py``).

With the JAX names and math: ``init_params`` (the same parameter tree,
leaf names and stacked ``[L, …]`` shapes), the norms, rope, the
activation, the dense MLP, the LM head, the GQA einsum ``attention`` with
its additive ``_mask_bias``, the block and :func:`forward` over the dense
``KVCache``. Parameters are a plain nested dict of tensors — no
``nn.Module`` — so a JAX tree moves over leaf for leaf
(``convert.py::params_from_jax``). Norm statistics and rope run in
float32 and cast back to the activation dtype, as in the JAX package.

:func:`forward` is the single-stage case of the JAX ``_stage_impl``; the
``lax.scan`` over layers is a loop over :func:`_layers`. A fresh-cache
prefill may route attention through ``ops.attention.flash_attention``
(the gate is :func:`flash_gate`), which on a CUDA tensor launches the
flash kernel (``ops/csrc/flash_attention.cu``).

MoE (``n_experts > 0``) runs the JAX package's dense dispatch
(:func:`_moe_mlp`: every expert sees every token, combined with the
softmax-normalised top-k gates), or the capacity-limited sparse dispatch
of ``parallel/expert.py`` when ``cfg.moe_dispatch == "sparse"``.

With no cache the forward is differentiable: training runs autograd
through it, nothing on that path writes in place, and ``remat=True``
checkpoints each block (``torch.utils.checkpoint``, the counterpart of
JAX's ``jax.checkpoint`` with ``nothing_saveable``). :func:`stage_forward`
runs one pipeline stage — a layer slice fed tokens or hidden states, with
or without the head, over a session cache sized to the slice — and
:func:`head_forward` is the final norm and LM head alone (the tied head's
hop back to stage 0).

Explicit tensor parallelism: :func:`tp_shardable`,
:func:`tp_partition_specs` (the serving spec tree ``parallel/mesh.py::put``
places a tree by), :func:`partition_specs` (the Megatron one) and the one
sharded block epilogue (:func:`_tp_residual`, :func:`_tp_mlp`,
:func:`_tp_logits` over a :class:`TPLayout`: split activations rejoin by
:meth:`TPLayout.join`, row-split partial products by the fixed-order
:meth:`TPLayout.sum_at`). ``engine/paged.py::make_tp_ragged_step`` runs it over
per-shard trees, and ``models/sharded.py`` runs the dense forward over a
tree placed on a ``{data, fsdp, expert, tensor}`` mesh (JAX's GSPMD path;
its cache by :func:`cache_specs`) with it, each shard's attention through
:func:`_attend` and each expert shard's block of experts through
:func:`_moe_block`.

Sequence parallelism (``seq_mesh``): each device of the mesh's ``seq``
axis runs its ``T/n`` rows through the row-local work — the embedding,
norms, projections, rope at the global positions, the MLP and the head —
and attention alone crosses blocks, through
``parallel/ring.py::ring_attention`` (:func:`_seq_stage`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.devices import resolve_device
from ..parallel.mesh import REPLICATED, Split, hop, is_sharded, to_device
from .base import KVCache, ModelConfig
from .quant import QTensor
from .quant import matmul as _mm
from .quant import quantize_kv


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator | None = None,
    device=None,
    dtype: torch.dtype | None = None,
) -> dict:
    """Random-init parameter tree: the JAX tree's leaf names and shapes,
    layers stacked ``[L, …]`` under ``params["layers"]``. Weights are
    drawn in float32 on ``device`` (so a full-width vocab matrix is never
    built on the host first) from ``generator`` — which must live on that
    device — then cast to ``dtype``. ``device=None`` is the CUDA card.
    A MoE config draws ``router`` ``[L, d, E]``, ``w_gate``/``w_up``
    ``[L, E, d, f]`` and ``w_down`` ``[L, E, f, d]``."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    L, V = cfg.n_layers, cfg.vocab_size

    def dense(*shape, scale=None):
        s = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(
            shape, generator=generator, device=dev, dtype=torch.float32
        )
        return (w * s).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    def norm_p(with_bias: bool, *shape):
        p = {"scale": ones(*shape)}
        if with_bias:
            p["bias"] = zeros(*shape)
        return p

    ln_bias = cfg.norm == "layernorm"
    attn = {
        "wq": dense(L, d, cfg.q_dim),
        "wk": dense(L, d, cfg.kv_dim),
        "wv": dense(L, d, cfg.kv_dim),
        "wo": dense(L, cfg.q_dim, d),
    }
    if cfg.attn_bias:
        attn |= {
            "bq": zeros(L, cfg.q_dim),
            "bk": zeros(L, cfg.kv_dim),
            "bv": zeros(L, cfg.kv_dim),
        }
    if cfg.attn_out_bias or cfg.family == "gpt2":
        attn["bo"] = zeros(L, d)
    if cfg.qk_norm:
        attn |= {"q_norm": ones(L, hd), "k_norm": ones(L, hd)}
    if cfg.qk_norm_full:
        attn |= {"q_norm": ones(L, cfg.q_dim), "k_norm": ones(L, cfg.kv_dim)}

    if cfg.moe:
        E = cfg.n_experts
        mlp = {
            "router": dense(L, d, E),
            "w_gate": dense(L, E, d, f),
            "w_up": dense(L, E, d, f),
            "w_down": dense(L, E, f, d, scale=f**-0.5),
        }
    elif cfg.mlp == "gated":
        mlp = {
            "w_gate": dense(L, d, f),
            "w_up": dense(L, d, f),
            "w_down": dense(L, f, d, scale=f**-0.5),
        }
        if cfg.mlp_bias:
            mlp |= {
                "b_gate": zeros(L, f),
                "b_up": zeros(L, f),
                "b_down": zeros(L, d),
            }
    else:  # fused (GPT-2): up -> act -> down, with biases
        mlp = {
            "w_up": dense(L, d, f),
            "b_up": zeros(L, f),
            "w_down": dense(L, f, d, scale=f**-0.5),
            "b_down": zeros(L, d),
        }

    params = {
        "embed": {"tok": dense(V, d, scale=0.02)},
        "layers": {
            "ln1": norm_p(ln_bias, L, d),
            "attn": attn,
            "ln2": norm_p(ln_bias, L, d),
            "mlp": mlp,
        },
        "final_norm": norm_p(ln_bias, d),
    }
    if cfg.pos == "learned":
        params["embed"]["pos"] = dense(cfg.max_seq_len, d, scale=0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, V)
    return params


def _norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        scale = p["scale"].float()
        if cfg.norm_plus_one:  # Gemma stores the rmsnorm weight as an offset
            scale = scale + 1.0
        var = (xf**2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * scale
    return out.to(x.dtype)


def _rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Qwen3 per-head RMSNorm over head_dim."""
    xf = x.float()
    out = xf * torch.rsqrt((xf**2).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables ``[B, T, head_dim]`` in the HF half-split convention
    (rotate_half): frequencies repeat over the two halves."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        exps,
    )
    ang = positions.float()[..., None] * inv_freq  # [B, T, half]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, hd]; cos/sin: [B, T, hd] (HF rotate_half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    out = x.float() * cos[..., None, :] + rotated.float() * sin[..., None, :]
    return out.to(x.dtype)


def _rope_dim(cfg: ModelConfig) -> int:
    """Rotary dims per head (GPT-NeoX applies rotary to a prefix only)."""
    rd = int(cfg.head_dim * cfg.rope_pct)
    return rd - rd % 2


def _embed_tokens(params: dict, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"]["tok"][tokens].to(cfg.dtype)
    if cfg.embed_scale:  # Gemma normalizer, cast to activation dtype like HF
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu_exact":
        return F.gelu(x)  # GPT-NeoX "gelu" (erf)
    return F.gelu(x, approximate="tanh")  # GPT-2 gelu_new


def _mlp(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """MLP block: MoE, gated or fused."""
    if cfg.moe:
        return _moe_mlp(h, p, cfg)
    if cfg.mlp == "gated":
        g = _mm(h, p["w_gate"])
        u = _mm(h, p["w_up"])
        if "b_gate" in p:
            g = g + p["b_gate"]
            u = u + p["b_up"]
        out = _mm(_act(g, cfg.act) * u, p["w_down"])
        if "b_down" in p:
            out = out + p["b_down"]
        return out
    mid = _act(_mm(h, p["w_up"]) + p["b_up"], cfg.act)
    return _mm(mid, p["w_down"]) + p["b_down"]


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order and their indices, ties going to the lower index (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_gates(h: torch.Tensor, router, cfg: ModelConfig) -> torch.Tensor:
    """The dense dispatch's float32 gates ``[..., E]``: the softmax over
    the top-k router logits at the chosen experts, zero elsewhere."""
    router_logits = _mm(h, router).float()  # [..., E]
    topw, topi = top_k(router_logits, cfg.n_experts_per_tok)
    return torch.zeros_like(router_logits).scatter(
        -1, topi, torch.softmax(topw, dim=-1))


def _moe_block(h: torch.Tensor, p: dict, gates: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Every token through the experts ``p`` holds, each output weighted
    by its gate (``gates``: those experts' columns) and summed."""
    g = torch.einsum("btd,edf->btef", h, p["w_gate"])
    u = torch.einsum("btd,edf->btef", h, p["w_up"])
    y = torch.einsum("btef,efd->bted", _act(g, cfg.act) * u, p["w_down"])
    return torch.einsum("bted,bte->btd", y, gates.to(h.dtype))


def _moe_mlp(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mixtral-style top-k MoE, dense dispatch: every expert sees every
    token and the outputs combine with the top-k gates (the softmax over
    the chosen experts' float32 router logits, zero elsewhere), as the
    JAX ``_moe_mlp``. ``cfg.moe_dispatch == "sparse"`` routes to the
    capacity-limited dispatch (``parallel/expert.py``). Over expert
    shards, ``parallel/expert.py::placed_moe_mlp`` runs the same two
    halves: the whole router's gates, and each shard's block of experts
    weighted by its own gates."""
    if cfg.moe_dispatch == "sparse":
        from ..parallel.expert import sparse_moe_mlp

        return sparse_moe_mlp(h, p, cfg)
    return _moe_block(h, p, _moe_gates(h, p["router"], cfg), cfg)


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LM head: the tied embedding's transpose, or ``lm_head``, plus the
    optional Gemma-style soft cap (over a placed tree: each shard's
    vocabulary columns, ``models/sharded.py``)."""
    if is_sharded(params):
        from . import sharded

        return sharded.logits(params, x, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].T.to(cfg.dtype)
    else:
        logits = _mm(x, params["lm_head"])
    if cfg.logit_cap is not None:
        logits = cfg.logit_cap * torch.tanh(logits / cfg.logit_cap)
    return logits


def attention(
    q: torch.Tensor,  # [B, T, Hq, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    mask_bias: torch.Tensor,  # [B, 1, 1, T, S] float32 additive
    scale: float,
) -> torch.Tensor:
    """Grouped-query attention without materializing repeated KV. Scores
    in float32 (JAX's ``preferred_element_type``), softmax weights cast to
    ``v``'s dtype before the PV product, as in JAX."""
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    scores = scores * scale + mask_bias
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(B, T, Hq, hd)


def _quant_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over head_dim with per-(row, position, head) scales
    ``[..., 1]`` — the dense int8 cache's write path
    (``models/quant.py::quantize_kv`` with a trailing unit axis)."""
    q, scale = quantize_kv(t)
    return q, scale[..., None]


def _layers(params: dict) -> list[dict]:
    """Per-layer views of the stacked ``params["layers"]`` tree — the
    port's counterpart of ``lax.scan`` slicing the leading ``L`` axis. A
    ``QTensor`` slices its ``q`` and its ``[L, 1, out]`` scale together."""
    tree = params["layers"]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if isinstance(t, QTensor):
            return QTensor(q=t.q[i], scale=t.scale[i])
        return t[i]

    n = tree["attn"]["wq"].shape[0]
    return [take(tree, i) for i in range(n)]


def _qkv(h, lp, cfg: ModelConfig, cos, sin):
    """The blocks' projection prologue — q/k/v with biases, both qk-norm
    variants and (partial-dim) rope, over a ``[B, T, d]`` input; returns
    ``[B, T, H, hd]`` each."""
    ap = lp["attn"]
    q, k, v = _qkv_proj(h, ap)
    if cfg.qk_norm_full:
        q, k = _qk_full_norm(q, k, ap, cfg)
    return _qkv_heads(q, k, v, ap, cfg, cos, sin)


def _qkv_proj(h, ap: dict) -> tuple:
    """:func:`_qkv`'s projections with their biases: ``[B, T, n]`` each
    (whole, or a shard's columns)."""
    q = _mm(h, ap["wq"])
    k = _mm(h, ap["wk"])
    v = _mm(h, ap["wv"])
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    return q, k, v


def _qk_full_norm(q, k, ap: dict, cfg: ModelConfig) -> tuple:
    """OLMo-2's RMSNorm over the whole q and k projections, before the
    reshape into heads."""
    return (_rms_head_norm(q, ap["q_norm"], cfg.norm_eps),
            _rms_head_norm(k, ap["k_norm"], cfg.norm_eps))


def _qkv_heads(q, k, v, ap: dict, cfg: ModelConfig, cos, sin) -> tuple:
    """:func:`_qkv` after the projections (and the whole-projection norm):
    the reshape into heads, the per-head qk-norm and rope."""
    B, T = q.shape[:2]
    q = q.reshape(B, T, -1, cfg.head_dim)
    k = k.reshape(B, T, -1, cfg.head_dim)
    v = v.reshape(B, T, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = _rms_head_norm(q, ap["q_norm"], cfg.norm_eps)
        k = _rms_head_norm(k, ap["k_norm"], cfg.norm_eps)
    if cos is not None:
        rd = cos.shape[-1]
        if rd == cfg.head_dim:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        else:  # partial rotary (GPT-NeoX): prefix rotates, rest passes
            q = torch.cat([apply_rope(q[..., :rd], cos, sin), q[..., rd:]],
                          dim=-1)
            k = torch.cat([apply_rope(k[..., :rd], cos, sin), k[..., rd:]],
                          dim=-1)
    return q, k, v


def _residual(x, attn_raw, lp, cfg: ModelConfig):
    """The blocks' epilogue: output projection (+bias) and the
    norm-position / parallel-residual wiring. ``attn_raw`` is
    ``[B, T, Hq, hd]``."""
    h, finish = _pre_mlp(x, attn_raw, lp, cfg)
    return finish(_mlp(h, lp["mlp"], cfg))


def _pre_mlp(x, attn_raw, lp, cfg: ModelConfig) -> tuple:
    """:func:`_residual` up to the MLP: ``(h, finish)``, the MLP's input
    and the function that takes the MLP's output to the block's."""
    B, T = attn_raw.shape[:2]
    ap = lp["attn"]
    attn_out = _mm(attn_raw.reshape(B, T, -1), ap["wo"])
    if "bo" in ap:
        attn_out = attn_out + ap["bo"]
    if cfg.norm_position == "post":  # OLMo-2: ln1/ln2 norm sublayer outputs
        x = x + _norm(attn_out, lp["ln1"], cfg)
        return x, lambda m: x + _norm(m, lp["ln2"], cfg)
    if cfg.parallel_residual:  # GPT-NeoX: both branches read the input
        return _norm(x, lp["ln2"], cfg), lambda m: x + attn_out + m
    x = x + attn_out
    return _norm(x, lp["ln2"], cfg), lambda m: x + m


# ---------------------------------------------------------------------------
# Explicit tensor parallelism (the paged serving path)
# ---------------------------------------------------------------------------


def tp_shardable(cfg: ModelConfig, tp: int) -> str | None:
    """Why ``cfg`` can NOT shard ``tp`` ways on the explicit serving TP
    path, or ``None`` when it can (the JAX function's reasons, word for
    word): MoE (routing is global), ``qk_norm_full`` (its RMSNorm spans
    the whole projection dim), and divisibility of the heads, ``d_ff``,
    ``d_model`` and an untied vocabulary."""
    tp = int(tp)
    if tp <= 1:
        return None
    if cfg.moe:
        return "MoE routing is not tensor-shardable on the serving path"
    if cfg.qk_norm_full:
        return "qk_norm_full normalizes over the full projection dim"
    for name in ("n_heads", "n_kv_heads", "d_ff", "d_model"):
        val = int(getattr(cfg, name))
        if val % tp:
            return f"{name}={val} is not divisible by tp={tp}"
    if not cfg.tie_embeddings and cfg.vocab_size % tp:
        return f"untied vocab_size={cfg.vocab_size} is not divisible by tp={tp}"
    return None


def tp_partition_specs(cfg: ModelConfig, axis: str = "tp") -> dict:
    """The spec tree of the explicit serving TP path: the parameter
    tree's exact structure with a :class:`~..parallel.mesh.Split` leaf
    each (walkable by dot-path, as the loader does). Every matmul weight
    splits its OUTPUT dim (``wo`` and ``w_down`` too: their output
    columns, the input whole) and biases split with the outputs they add
    onto; embeddings, norms and the per-head qk-norm scales replicate.
    Column slices of a product are the product's columns, and the
    activations reassemble by a fixed-order concatenation, which is what
    keeps tp=N streams equal to tp=1. Gate with :func:`tp_shardable`."""
    if cfg.moe:
        raise ValueError("MoE params have no explicit-TP partition specs")
    rep = REPLICATED
    out2, out1 = Split(2, axis), Split(1, axis)  # [L, in, out] / [L, out]

    ln = {"scale": rep}
    if cfg.norm == "layernorm":
        ln["bias"] = rep
    attn = {"wq": out2, "wk": out2, "wv": out2, "wo": out2}
    if cfg.attn_bias:
        attn |= {"bq": out1, "bk": out1, "bv": out1}
    if cfg.attn_out_bias or cfg.family == "gpt2":  # must match init_params
        attn["bo"] = out1
    if cfg.qk_norm or cfg.qk_norm_full:
        attn |= {"q_norm": rep, "k_norm": rep}
    if cfg.mlp == "gated":
        mlp = {"w_gate": out2, "w_up": out2, "w_down": out2}
        if cfg.mlp_bias:
            mlp |= {"b_gate": out1, "b_up": out1, "b_down": out1}
    else:
        mlp = {"w_up": out2, "b_up": out1, "w_down": out2, "b_down": out1}
    specs = {
        "embed": {"tok": rep},
        "layers": {"ln1": ln, "attn": attn, "ln2": dict(ln), "mlp": mlp},
        "final_norm": {"scale": rep}
        | ({"bias": rep} if cfg.norm == "layernorm" else {}),
    }
    if cfg.pos == "learned":
        specs["embed"]["pos"] = rep
    if not cfg.tie_embeddings:
        specs["lm_head"] = Split(1, axis)
    return specs


def partition_specs(
    cfg: ModelConfig,
    *,
    tensor_axis: str | None = "tensor",
    expert_axis: str | None = None,
    fsdp_axis: str | None = None,
) -> dict:
    """The Megatron-style spec tree of the JAX ``partition_specs`` (the
    GSPMD dense path): q/k/v, gate and up split their output columns over
    ``tensor_axis``, ``wo``/``w_down`` their input rows, the embedding
    its vocabulary rows and ``lm_head`` its vocabulary columns; norms,
    the output biases and the router replicate. ``fsdp_axis`` also splits
    each large weight's other dimension over ``fsdp`` (ZeRO-3):
    ``wq`` is ``P(None, "fsdp", "tensor")``, ``wo`` ``P(None, "tensor",
    "fsdp")``, the embedding ``P("tensor", "fsdp")``. ``expert_axis``
    splits the MoE experts' leading dimension over ``expert``: ``w_gate``
    is ``P(None, "expert", "fsdp", "tensor")``, the router replicates.
    ``models/sharded.py`` runs the forward over a tree placed by it."""
    for name, axis in (("fsdp", fsdp_axis), ("expert", expert_axis)):
        if axis not in (None, name):
            raise ValueError(f"the {name} dimension splits over "
                             f"{name!r}, not {axis!r}")
    t, fs, e = tensor_axis, fsdp_axis, expert_axis

    def sp(dim: int | None, fdim: int | None = None,
           edim: int | None = None) -> Split:
        dim = dim if t is not None else None
        return Split(dim, "tp" if dim is None else t,
                     fsdp_dim=fdim if fs is not None else None,
                     expert_dim=edim if e is not None else None)

    rep = REPLICATED
    ln = {"scale": rep}
    if cfg.norm == "layernorm":
        ln["bias"] = rep
    attn = {"wq": sp(2, 1), "wk": sp(2, 1), "wv": sp(2, 1), "wo": sp(1, 2)}
    if cfg.attn_bias:
        attn |= {"bq": sp(1), "bk": sp(1), "bv": sp(1)}
    if cfg.attn_out_bias or cfg.family == "gpt2":  # must match init_params
        attn["bo"] = rep
    if cfg.qk_norm:
        attn |= {"q_norm": rep, "k_norm": rep}
    if cfg.qk_norm_full:  # the scales align with the split projections
        attn |= {"q_norm": sp(1), "k_norm": sp(1)}
    if cfg.moe:
        mlp = {"router": rep, "w_gate": sp(3, 2, 1), "w_up": sp(3, 2, 1),
               "w_down": sp(2, 3, 1)}
    elif cfg.mlp == "gated":
        mlp = {"w_gate": sp(2, 1), "w_up": sp(2, 1), "w_down": sp(1, 2)}
        if cfg.mlp_bias:
            mlp |= {"b_gate": sp(1), "b_up": sp(1), "b_down": rep}
    else:
        mlp = {"w_up": sp(2, 1), "b_up": sp(1), "w_down": sp(1, 2),
               "b_down": rep}
    specs = {
        "embed": {"tok": sp(0, 1)},
        "layers": {"ln1": ln, "attn": attn, "ln2": dict(ln), "mlp": mlp},
        "final_norm": {"scale": rep}
        | ({"bias": rep} if cfg.norm == "layernorm" else {}),
    }
    if cfg.pos == "learned":
        specs["embed"]["pos"] = sp(None, 1)
    if not cfg.tie_embeddings:
        specs["lm_head"] = sp(1, 0)
    return specs


def cache_specs(cfg: ModelConfig, *, data_axis: str | None = "data",
                tensor_axis: str | None = "tensor",
                quantized: bool = False) -> KVCache:
    """The dense cache's spec (JAX ``cache_specs``): the batch on
    ``data``, the kv heads on ``tensor_axis`` (each None to keep it
    whole), the int8 scales split like their payload and ``length`` with
    the batch."""
    if data_axis not in (None, "data"):
        raise ValueError(f"the cache's batch splits over 'data', not "
                         f"{data_axis!r}")
    kv = Split(3 if tensor_axis else None, tensor_axis or "tp",
               1 if data_axis else None)
    return KVCache(
        k=kv, v=kv,
        length=Split(0, "data") if data_axis else REPLICATED,
        k_scale=kv if quantized else None,
        v_scale=kv if quantized else None,
    )


def _tp_sum(parts: list, device) -> torch.Tensor:
    """Reduce the shards' partial products in a fixed order on ``device``:
    ``((p0 + p1) + p2) + …``, shard 0 first, whatever the shard count."""
    acc = to_device(parts[0], device)
    for p in parts[1:]:
        acc = acc + to_device(p, device)
    return acc


def _plus(y: torch.Tensor, b) -> torch.Tensor:
    return y if b is None else y + b


class TPLayout:
    """Where a tensor-parallel forward runs and how its weights lie.
    Shard ``i`` runs on ``devices[i]`` (mesh order); the replicated work
    — embedding, norms, residual adds — runs once on each distinct
    device, with the parameters of the first shard there. A replicated
    activation is a dict ``{device: tensor}``.

    ``wo``, ``up``/``down`` (the MLP's input and output projections),
    ``tok`` (the embedding table) and ``head`` (an untied ``lm_head``)
    each name how that weight lies over the shards: ``"rep"`` whole on
    every shard, ``"col"`` split along its output columns, ``"row"``
    along its input rows (the embedding: its vocabulary rows). The
    defaults are :func:`tp_partition_specs`' (every product by column);
    ``models/sharded.py`` reads them off a placed tree.

    ``quant`` (``ModelConfig.collective_quant``) makes every gather of a
    split activation the int8 one
    (``parallel/ring.py::quantized_all_gather``, tiled): each shard
    quantized once, dequantized with its own scales on every reader, in
    the same mesh order.

    ``mesh`` and ``positions`` (shard ``i``'s flattened position of the
    mesh) tie the shards to a placed tree's mesh (``models/sharded.py``):
    the work on a distinct device is its first shard's position, and
    every read of a value at another position is a
    ``parallel/mesh.py::hop`` — on a mesh over several processes the only
    place values cross them. Without them (the paged serving step) a
    read is the value, or its copy onto the reader's device."""

    def __init__(self, devices, *, wo: str = "col", up: str = "col",
                 down: str = "col", tok: str = "rep", head: str = "col",
                 quant: bool = False, mesh=None, positions=None):
        self.devices = [torch.device(d) for d in devices]
        self.first: dict[torch.device, int] = {}
        for i, d in enumerate(self.devices):
            self.first.setdefault(d, i)
        self.distinct = list(self.first)
        self.primary = self.devices[0]
        self.wo, self.up, self.down = wo, up, down
        self.tok, self.head = tok, head
        self.quant = bool(quant)
        self.mesh = mesh
        self.pos = list(positions) if positions is not None else None
        if mesh is not None and quant:
            raise ValueError("the quantized gathers run on the paged "
                             "serving step only")

    @property
    def tp(self) -> int:
        return len(self.devices)

    def here(self, d) -> torch.device:
        """Where this process runs distinct device ``d``'s work: ``d``, or
        ``meta`` when another process owns it."""
        if self.mesh is None:
            return d
        return self.mesh.here(self.pos[self.first[d]])

    def at(self, i: int) -> torch.device:
        """Where this process runs shard ``i``'s work."""
        if self.mesh is None:
            return self.devices[i]
        return self.mesh.here(self.pos[i])

    def to_shard(self, v: torch.Tensor, d, i: int) -> torch.Tensor:
        """Distinct device ``d``'s value ``v``, read by shard ``i``."""
        if self.mesh is None:
            return v
        return hop(v, self.mesh, self.pos[self.first[d]], self.pos[i])

    def to_rep(self, v: torch.Tensor, i: int, d) -> torch.Tensor:
        """Shard ``i``'s value ``v``, read by the work on device ``d``."""
        if self.mesh is None:
            return to_device(v, d)
        return hop(v, self.mesh, self.pos[i], self.pos[self.first[d]])

    def join(self, parts: list, d) -> torch.Tensor:
        """Reassemble an activation whose LAST axis is split over the
        shards: the pieces concatenated in mesh order on ``d`` — JAX's
        tiled ``all_gather``, so the whole activation is the same bits on
        every device and equal to the unsharded compute's."""
        moved = [self.to_rep(p, i, d) for i, p in enumerate(parts)]
        return moved[0] if len(moved) == 1 else torch.cat(moved, dim=-1)

    def sum_at(self, parts: list, d) -> torch.Tensor:
        """The shards' partial products summed on ``d`` in a fixed order,
        shard 0 first (:func:`_tp_sum`)."""
        moved = [self.to_rep(p, i, d) for i, p in enumerate(parts)]
        return _tp_sum(moved, moved[0].device)

    def gather(self, parts: list, devices=None) -> dict:
        """Each distinct device's copy (or each of ``devices``') of the
        reassembled activation."""
        devices = self.distinct if devices is None else devices
        if not self.quant or len(parts) == 1:
            return {d: self.join(parts, d) for d in devices}
        from ..parallel.ring import quantize_shards, quantized_all_gather

        wire = quantize_shards(parts)
        return {d: quantized_all_gather(parts, d, axis=-1, tiled=True,
                                        quantized=wire) for d in devices}

    def rep(self, per_shard: list) -> dict:
        """``{device: the first shard's value there}``."""
        return {d: per_shard[i] for d, i in self.first.items()}


def _tp_project(lay: TPLayout, kind: str, x, weight, bias) -> dict:
    """``X @ W (+ b)`` over the shards, whole on every distinct device.
    ``x`` is the input split along its last axis (a list, shard ``i``'s
    piece) or whole (a dict ``{device: tensor}``); ``weight(i)`` and
    ``bias(i)`` read shard ``i``'s leaves. By ``kind``: ``"col"`` each
    shard makes its output columns from the whole input, gathered;
    ``"row"`` each shard its partial product over its input rows, summed
    shard 0 first (:meth:`TPLayout.sum_at`), the whole bias added once
    after; ``"rep"`` the whole product once per distinct device."""
    if kind == "row":
        if isinstance(x, dict):  # each shard's slice of its device's whole
            w = next(iter(x.values())).shape[-1] // lay.tp
            x = [lay.to_shard(x[d][..., i * w:(i + 1) * w], d, i)
                 for i, d in enumerate(lay.devices)]
        partial = [_mm(p, weight(i)) for i, p in enumerate(x)]
        return {d: _plus(lay.sum_at(partial, d), bias(i))
                for d, i in lay.first.items()}
    whole = x if isinstance(x, dict) else lay.gather(x)
    if kind == "col":
        return lay.gather([_plus(_mm(lay.to_shard(whole[d], d, i),
                                     weight(i)), bias(i))
                           for i, d in enumerate(lay.devices)])
    return {d: _plus(_mm(whole[d], weight(i)), bias(i))
            for d, i in lay.first.items()}


def _tp_mlp(h: dict, mlps: list, cfg: ModelConfig, lay: TPLayout) -> dict:
    """The MLP over shards — JAX's ``_mlp`` with ``tp_axis``: each
    shard's gate/up columns, then ``w_down`` by :func:`_tp_project`. A
    replicated MLP (a whole MoE layer too) runs whole once per distinct
    device; a split MoE layer runs over its shards in
    ``parallel/expert.py::placed_moe_mlp``."""
    if lay.up == "rep":
        return {d: _mlp(x, mlps[lay.first[d]], cfg) for d, x in h.items()}
    mids = []
    for i, (p, d) in enumerate(zip(mlps, lay.devices)):
        x = lay.to_shard(h[d], d, i)
        if cfg.mlp == "gated":
            g = _mm(x, p["w_gate"])
            u = _mm(x, p["w_up"])
            if "b_gate" in p:
                g = g + p["b_gate"]
                u = u + p["b_up"]
            mids.append(_act(g, cfg.act) * u)
        else:
            mids.append(_act(_mm(x, p["w_up"]) + p["b_up"], cfg.act))
    return _tp_project(lay, lay.down, mids, lambda i: mlps[i]["w_down"],
                       lambda i: mlps[i].get("b_down"))


def _tp_residual(x: dict, attn, lps: list, cfg: ModelConfig,
                 lay: TPLayout) -> dict:
    """:func:`_residual` over shards: :func:`_tp_pre_mlp`, then
    :func:`_tp_mlp` and the residual add."""
    h, finish = _tp_pre_mlp(x, attn, lps, cfg, lay)
    return finish(_tp_mlp(h, [lp["mlp"] for lp in lps], cfg, lay))


def _tp_pre_mlp(x: dict, attn, lps: list, cfg: ModelConfig,
                lay: TPLayout) -> tuple:
    """:func:`_residual` over shards up to the MLP: ``(h, finish)``, the
    MLP's input on each distinct device and the function that takes the
    MLP's output there (a dict) to the block's output. ``attn`` is each
    shard's attention output over its own heads (a list of ``[B, T,
    Hq/tp, hd]``) or the whole output on each distinct device (a dict of
    ``[B, T, Hq, hd]``); ``wo`` projects it by :func:`_tp_project`. The
    residual stream ``x`` is whole on every device, so the norms and adds
    are the unsharded ones."""
    def flat(a):
        return a.reshape(a.shape[0], a.shape[1], -1)

    attn = ({d: flat(a) for d, a in attn.items()} if isinstance(attn, dict)
            else [flat(a) for a in attn])
    attn_out = _tp_project(lay, lay.wo, attn,
                           lambda i: lps[i]["attn"]["wo"],
                           lambda i: lps[i]["attn"].get("bo"))
    rep = lay.rep(lps)
    if cfg.norm_position == "post":
        x = {d: x[d] + _norm(attn_out[d], rep[d]["ln1"], cfg) for d in x}
        return x, lambda m: {d: x[d] + _norm(m[d], rep[d]["ln2"], cfg)
                             for d in x}
    if cfg.parallel_residual:
        return ({d: _norm(x[d], rep[d]["ln2"], cfg) for d in x},
                lambda m: {d: x[d] + attn_out[d] + m[d] for d in x})
    x = {d: x[d] + attn_out[d] for d in x}
    return ({d: _norm(x[d], rep[d]["ln2"], cfg) for d in x},
            lambda m: {d: x[d] + m[d] for d in x})


def _tp_logits(shards: list, x: dict, cfg: ModelConfig,
               lay: TPLayout) -> torch.Tensor:
    """The LM head over shards, on the primary device: a replicated head
    (or tied table) runs whole there; a split one makes each shard's
    vocabulary columns — ``lm_head``'s columns, or the tied table's rows
    transposed — and they gather."""
    if (lay.tok if cfg.tie_embeddings else lay.head) == "rep":
        return _logits(shards[0], x[lay.primary], cfg)
    xs = [lay.to_shard(x[d], d, i) for i, d in enumerate(lay.devices)]
    if cfg.tie_embeddings:
        parts = [xi @ p["embed"]["tok"].T.to(cfg.dtype)
                 for p, xi in zip(shards, xs)]
    else:
        parts = [_mm(xi, p["lm_head"]) for p, xi in zip(shards, xs)]
    logits = lay.gather(parts, [lay.primary])[lay.primary]
    if cfg.logit_cap is not None:
        logits = cfg.logit_cap * torch.tanh(logits / cfg.logit_cap)
    return logits


def _attn_scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim**-0.5


def _write_rows(c: torch.Tensor, u: torch.Tensor,
                start: torch.Tensor) -> None:
    """In place, per batch row: ``c[b, start[b] : start[b] + T] = u[b]``
    with the start clamped to ``[0, S - T]`` so the update fits — what
    ``lax.dynamic_update_slice`` does (a row frozen at full room rewrites
    its last slot)."""
    S, T = c.shape[1], u.shape[1]
    o = torch.clamp(start.long(), 0, S - T)
    pos = o[:, None] + torch.arange(T, device=c.device)[None, :]
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    c[rows, pos] = u


def _attend(q, k, v, cfg: ModelConfig, mask_bias, cache_kv, write_at,
            attn_fn=None, kv_upto: int | None = None) -> torch.Tensor:
    """A block's attention after its projections: with a cache
    (``cache_kv``: ``(k, v)`` or ``(k, v, k_scale, v_scale)``), this
    step's k/v land at each row's ``write_at`` (in place; int8 mode
    quantizes them there) and attention reads the whole cache — or its
    first ``kv_upto`` positions, which is all a fresh-cache flash prefill
    reads — dequantized to the activation dtype."""
    if cache_kv is not None:
        if len(cache_kv) == 4:  # int8 cache: quantize writes, dequant reads
            ck, cv, cks, cvs = cache_kv
            k8, ks = _quant_kv(k)
            v8, vs = _quant_kv(v)
            for c, u in ((ck, k8), (cv, v8), (cks, ks), (cvs, vs)):
                _write_rows(c, u, write_at)
            ck, cv, cks, cvs = (t[:, :kv_upto] for t in cache_kv)
            k_all = (ck.float() * cks).to(q.dtype)
            v_all = (cv.float() * cvs).to(q.dtype)
        else:
            ck, cv = cache_kv
            _write_rows(ck, k.to(ck.dtype), write_at)
            _write_rows(cv, v.to(cv.dtype), write_at)
            k_all, v_all = ck[:, :kv_upto], cv[:, :kv_upto]
    else:
        k_all, v_all = k, v
    impl = attn_fn or attention
    return impl(q, k_all.to(q.dtype), v_all.to(q.dtype), mask_bias,
                _attn_scale(cfg))


def _block(
    x: torch.Tensor,
    lp: dict,
    cfg: ModelConfig,
    cos,
    sin,
    mask_bias,
    # this layer's cache views: None | (k, v) | (k, v, k_scale, v_scale)
    cache_kv: tuple | None,
    write_at: torch.Tensor | None,  # int32 [B] write offsets
    attn_fn=None,  # override: (q, k, v, mask_bias, scale) -> out
    kv_upto: int | None = None,  # attend cache positions [0, kv_upto) only
):
    """One decoder block: the input norm, :func:`_qkv`, :func:`_attend`
    (over the cache, when there is one) and :func:`_residual`."""
    h = x if cfg.norm_position == "post" else _norm(x, lp["ln1"], cfg)
    q, k, v = _qkv(h, lp, cfg, cos, sin)
    attn_raw = _attend(q, k, v, cfg, mask_bias, cache_kv, write_at, attn_fn,
                       kv_upto)
    return _residual(x, attn_raw, lp, cfg)


def _mask_bias(
    q_pos: torch.Tensor,  # [B, T] absolute query positions
    kv_len: int,
    valid_kv: torch.Tensor,  # [B, S] bool — which kv slots hold real tokens
    sliding_window: int | None,
) -> torch.Tensor:
    """Additive float32 mask ``[B, 1, 1, T, S]``: causal (+ window) over
    absolute positions, padding through ``valid_kv``; masked entries are
    ``-inf`` as in JAX (a row with nothing visible softmaxes to NaN in
    both packages — only bucket-padding rows, whose outputs are never
    read)."""
    kv_idx = torch.arange(kv_len, device=q_pos.device)[None, None, :]
    qp = q_pos.long()[:, :, None]
    ok = kv_idx <= qp
    if sliding_window is not None:
        ok &= kv_idx > qp - sliding_window
    ok &= valid_kv[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, float("-inf"))[:, None, None]


def flash_gate(cfg: ModelConfig, T: int, has_cache: bool,
               flash_prefill: bool) -> bool:
    """Whether a forward of ``T`` tokens runs its attention through
    ``flash_attention``: a promised fresh-cache prefill (offset 0) with
    ``cfg.flash_attention`` set, more than one token, and ``T`` a multiple
    of ``min(128, T)`` — the JAX gate (an irregular bucket takes the
    einsum). The engine counts its flash prefills with the same rule."""
    return bool(flash_prefill and cfg.flash_attention and has_cache
                and T > 1 and T % min(128, T) == 0)


def forward(
    params: dict,
    tokens: torch.Tensor,  # int [B, T]
    cfg: ModelConfig,
    cache: KVCache | None = None,
    attn_mask: torch.Tensor | None = None,  # bool [B, T] valid-token mask
    positions: torch.Tensor | None = None,  # int [B, T] absolute positions
    remat: bool = False,
    return_hidden: bool = False,
    seq_mesh=None,
    flash_prefill: bool = False,
):
    """Full forward. Returns ``(logits, new_cache)`` — or the final-normed
    hidden states when ``return_hidden``.

    - No cache: causal self-attention over the sequence.
    - Prefill: pass a fresh ``cache``; keys/values land at positions
      ``cache.length + arange(T)`` per row (written in place).
    - Decode: the same call with ``T = 1``.

    ``flash_prefill`` promises a fresh cache (offset 0): with
    ``cfg.flash_attention`` set and :func:`flash_gate` passing, attention
    runs ``flash_attention`` over the cache's first ``T`` positions after
    this step's write (so an int8 cache feeds it dequantized keys, as in
    JAX).

    ``remat`` recomputes each block in the backward pass instead of
    keeping its activations (``torch.utils.checkpoint``, non-reentrant).

    ``seq_mesh`` (a mesh with a ``seq`` axis) runs the forward sequence
    parallel (:func:`_seq_stage`).

    The single-stage case of :func:`_stage_impl`, as in JAX."""
    if seq_mesh is not None:
        out, new_cache = _seq_stage(
            params, cfg, seq_mesh, tokens=tokens, cache=cache,
            attn_mask=attn_mask, positions=positions, first=True,
            last=not return_hidden, remat=remat)
        if return_hidden:
            out = _norm(out, params["final_norm"], cfg)
        return out, new_cache
    if is_sharded(params):
        from . import sharded

        return sharded.stage(
            params, cfg, tokens=tokens, cache=cache, attn_mask=attn_mask,
            positions=positions, first=True, last=not return_hidden,
            flash_prefill=flash_prefill, final_norm=return_hidden)
    if return_hidden:
        x, new_cache = _stage_impl(
            params, cfg, tokens=tokens, cache=cache, attn_mask=attn_mask,
            positions=positions, first=True, last=False, remat=remat,
            flash_prefill=flash_prefill)
        return _norm(x, params["final_norm"], cfg), new_cache
    return _stage_impl(
        params, cfg, tokens=tokens, cache=cache, attn_mask=attn_mask,
        positions=positions, first=True, last=True, remat=remat,
        flash_prefill=flash_prefill)


def _stage_impl(
    params: dict,
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor | None = None,
    hidden: torch.Tensor | None = None,
    cache: KVCache | None = None,
    attn_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    first: bool,
    last: bool,
    remat: bool = False,
    flash_prefill: bool = False,
):
    """One stage: embed ``tokens`` (``first``) or take ``hidden``, run the
    stage's layers (``params["layers"]``, however many it holds, each
    writing its own layer of ``cache``) and, when ``last``, the final
    norm and LM head. Returns ``(out, new_cache)``."""
    if first:
        if tokens is None:
            raise ValueError("first stage requires tokens")
        B, T = tokens.shape
        dev = tokens.device
    else:
        if hidden is None:
            raise ValueError("non-first stage requires hidden")
        B, T = hidden.shape[:2]
        dev = hidden.device
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if cache is not None:
        offset = cache.length
    else:
        offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    if positions is None:
        positions = offset.long()[:, None] + torch.arange(T, device=dev)[None]

    if first:
        x = _embed_tokens(params, tokens.long(), cfg)
        if cfg.pos == "learned":
            # clamped like JAX's out-of-bounds gather (a finished row of
            # the host-driven loop keeps stepping past the table)
            pos_idx = torch.clamp(positions.long(), 0, cfg.max_seq_len - 1)
            x = x + params["embed"]["pos"][pos_idx].to(cfg.dtype)
    else:
        x = hidden.to(cfg.dtype)
    cos = sin = None
    if cfg.pos == "rope":
        cos, sin = rope_tables(positions, _rope_dim(cfg), cfg.rope_theta)

    attn_fn, kv_upto, bias = None, None, None
    if flash_gate(cfg, T, cache is not None, flash_prefill):
        from ..ops.attention import flash_attention

        win = cfg.sliding_window

        def attn_fn(q, k_all, v_all, _bias, scale):
            return flash_attention(q, k_all, v_all, scale=scale, window=win)

        kv_upto = T  # offset 0: keys past T are the cache's zeros
    else:
        new_len = offset + attn_mask.sum(-1).to(torch.int32)
        if cache is not None:
            S = cache.max_len
            kv_idx = torch.arange(S, device=dev)[None, :]
            valid_kv = kv_idx < new_len[:, None]
        else:
            valid_kv = attn_mask
        bias = _mask_bias(positions, valid_kv.shape[-1], valid_kv,
                          cfg.sliding_window)

    layers = _layers(params) if "layers" in params else []
    for i, lp in enumerate(layers):
        kv = cache.layer_kv(i) if cache is not None else None
        if remat:
            x = checkpoint(_block, x, lp, cfg, cos, sin, bias, kv, offset,
                           attn_fn, kv_upto, use_reentrant=False)
        else:
            x = _block(x, lp, cfg, cos, sin, bias, kv, offset, attn_fn,
                       kv_upto)
    new_cache = cache
    if cache is not None and layers:
        new_cache = KVCache(
            k=cache.k, v=cache.v,
            length=offset + attn_mask.sum(-1).to(torch.int32),
            k_scale=cache.k_scale, v_scale=cache.v_scale,
        )
    if last:
        x = _norm(x, params["final_norm"], cfg)
        return _logits(params, x, cfg), new_cache
    return x, new_cache


def head_forward(params: dict, hidden: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head only (the JAX ``head_forward``): the
    tied-embedding hop, where the last stage ships its hidden states back
    to stage 0 for the logits."""
    if is_sharded(params):
        from . import sharded

        return sharded.head(params, hidden, cfg)
    x = _norm(hidden.to(cfg.dtype), params["final_norm"], cfg)
    return _logits(params, x, cfg)


def stage_forward(
    params: dict,
    cfg: ModelConfig,  # the FULL model's config (layers come from params)
    *,
    tokens: torch.Tensor | None = None,  # int [B, T] (first stage)
    hidden: torch.Tensor | None = None,  # [B, T, D] (later stages)
    cache: KVCache | None = None,  # this stage's cache (its layers only)
    attn_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    first: bool = False,
    last: bool = False,
    remat: bool = False,
    seq_mesh=None,
    seq_axis: str = "seq",
):
    """Run one pipeline stage: ``(out, new_cache)``, where ``out`` is the
    logits when ``last`` and else the hidden state for the next stage.

    A stage holds a contiguous layer slice (``params["layers"]`` stacked
    over just those layers) plus, per the plan's flags, the embedding
    (``first``) and the final norm and head (``last``). Chaining stages
    reproduces :func:`forward`. A tied-embedding plan keeps the head on
    stage 0: the final stage returns hidden states and the caller
    finishes with :func:`head_forward` there. A session cache is sized to
    the slice (``KVCache.init(cfg.with_(n_layers=hi - lo), ...)``).
    ``seq_mesh`` runs the stage sequence parallel over its ``seq_axis``
    (:func:`_seq_stage`)."""
    if seq_mesh is not None:
        return _seq_stage(
            params, cfg, seq_mesh, seq_axis=seq_axis, tokens=tokens,
            hidden=hidden, cache=cache, attn_mask=attn_mask,
            positions=positions, first=first, last=last, remat=remat)
    if is_sharded(params):
        from . import sharded

        return sharded.stage(
            params, cfg, tokens=tokens, hidden=hidden, cache=cache,
            attn_mask=attn_mask, positions=positions, first=first,
            last=last)
    return _stage_impl(
        params, cfg, tokens=tokens, hidden=hidden, cache=cache,
        attn_mask=attn_mask, positions=positions, first=first, last=last,
        remat=remat,
    )


def _seq_stage(
    params: dict,
    cfg: ModelConfig,
    mesh,
    *,
    seq_axis: str = "seq",
    tokens: torch.Tensor | None = None,
    hidden: torch.Tensor | None = None,
    cache: KVCache | None = None,
    attn_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    first: bool,
    last: bool,
    remat: bool = False,
    take=None,
):
    """A stage sequence parallel over ``mesh[seq_axis]``: ``(out, None)``,
    ``out`` whole on the mesh's first device. Device ``i`` of the axis
    runs rows ``[i·T/n, (i+1)·T/n)`` of every sequence through the
    row-local work with its own copy of the params (a placed leaf's piece
    there, joined when an axis splits it; a whole leaf moved there), and
    attention runs as the ring (``parallel/ring.py``), quantized when
    ``cfg.collective_quant``. A sparse MoE dispatch groups tokens over the
    whole batch, so its MLP runs over the blocks joined on the first
    device. The JAX refusals hold: no KV cache, no padding mask, no
    sliding window. ``take`` reads a placed tree's pieces (the train
    step's reader); ``remat`` checkpoints each block over every device,
    so over distinct cards its backward runs on one thread
    (``torch.autograd.set_multithreading_enabled(False)``, as
    ``engine/training.py::GradFold`` runs it): autograd's device threads
    would recompute one checkpointed block at once."""
    from ..parallel.mesh import Sharded
    from ..parallel.ring import ring_blocks

    if cache is not None:
        raise ValueError("sequence-parallel attention has no KV cache path")
    if attn_mask is not None:
        raise ValueError(
            "sequence-parallel attention does not support padding masks")
    if cfg.sliding_window is not None:
        raise ValueError(
            "sequence-parallel attention does not support sliding windows")
    x_in = tokens if first else hidden
    if x_in is None:
        raise ValueError("first stage requires tokens" if first
                         else "non-first stage requires hidden")
    B, T = x_in.shape[:2]
    flat = mesh.flat()
    members = mesh.axis_members(seq_axis)
    n = len(members)
    if T % n:
        raise ValueError(f"sequence length {T} does not split over the "
                         f"{seq_axis} axis of {n}")
    b = T // n
    devs = [flat[j] for j in members]
    dev0 = flat[0]

    def on(leaf, i):
        """Device ``i``'s copy of a leaf."""
        if isinstance(leaf, dict):
            return {k: on(v, i) for k, v in leaf.items()}
        if isinstance(leaf, QTensor):
            return QTensor(q=on(leaf.q, i), scale=on(leaf.scale, i))
        if isinstance(leaf, Sharded):
            read = ((lambda j: take(leaf, j, None)) if take is not None
                    else leaf.shards.__getitem__)
            if leaf.pieces() == 1:  # the piece that lies there
                return read(members[i])
            return leaf.full(devs[i], read)
        return to_device(leaf, devs[i])

    ps = [on(params, i) for i in range(n)]
    layers = [_layers(p) if "layers" in p else [] for p in ps]
    if positions is None:
        positions = torch.arange(T, device=x_in.device)[None, :].expand(B, T)
    xs, ropes = [], []
    for i, d in enumerate(devs):
        rows = slice(i * b, (i + 1) * b)
        pos = to_device(positions[:, rows], d)
        if first:
            x = _embed_tokens(ps[i], to_device(tokens[:, rows], d).long(),
                              cfg)
            if cfg.pos == "learned":
                pos_idx = torch.clamp(pos.long(), 0, cfg.max_seq_len - 1)
                x = x + ps[i]["embed"]["pos"][pos_idx].to(cfg.dtype)
        else:
            x = to_device(hidden[:, rows], d).to(cfg.dtype)
        xs.append(x)
        ropes.append(rope_tables(pos, _rope_dim(cfg), cfg.rope_theta)
                     if cfg.pos == "rope" else (None, None))
    quant = bool(cfg.collective_quant)
    joined_mlp = cfg.moe and cfg.moe_dispatch == "sparse" and n > 1

    def block(i, *xs):
        lps = [ls[i] for ls in layers]
        qs, ks, vs = [], [], []
        for x, lp, (cos, sin) in zip(xs, lps, ropes):
            h = x if cfg.norm_position == "post" else _norm(x, lp["ln1"], cfg)
            q, k, v = _qkv(h, lp, cfg, cos, sin)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        attn = ring_blocks(qs, ks, vs, scale=_attn_scale(cfg), causal=True,
                           quantized=quant)
        pre = [_pre_mlp(x, a, lp, cfg) for x, a, lp in zip(xs, attn, lps)]
        if joined_mlp:  # on the first device (the ring's first)
            h = torch.cat([to_device(h, dev0) for h, _ in pre], dim=1)
            m = _mlp(h, lps[0]["mlp"], cfg)
            ms = [to_device(m[:, k * b:(k + 1) * b], d)
                  for k, d in enumerate(devs)]
        else:
            ms = [_mlp(h, lp["mlp"], cfg) for (h, _), lp in zip(pre, lps)]
        return tuple(fin(m) for (_, fin), m in zip(pre, ms))

    for i in range(len(layers[0])):
        xs = (checkpoint(block, i, *xs, use_reentrant=False) if remat
              else block(i, *xs))
    if last:
        outs = [_logits(p, _norm(x, p["final_norm"], cfg), cfg)
                for p, x in zip(ps, xs)]
    else:
        outs = list(xs)
    return torch.cat([to_device(o, dev0) for o in outs], dim=1), None


def slice_stage_params(params: dict, lo: int, hi: int, *, first: bool,
                       holds_head: bool) -> dict:
    """One stage's tree cut from a full tree: layers ``lo..hi-1`` (views)
    and, per the flags, the embedding and the final norm and head (a tied
    head keeps the embedding) — the JAX ``slice_stage_params``."""
    out: dict = {}
    if first:
        out["embed"] = params["embed"]
    if holds_head:
        out["final_norm"] = params["final_norm"]
        if "lm_head" in params:
            out["lm_head"] = params["lm_head"]
        if "embed" not in out and "lm_head" not in params:
            out["embed"] = params["embed"]  # the tied head needs it
    if hi > lo:
        def cut(t):
            if isinstance(t, dict):
                return {k: cut(v) for k, v in t.items()}
            if isinstance(t, QTensor):
                return QTensor(q=t.q[lo:hi], scale=t.scale[lo:hi])
            return t[lo:hi]

        out["layers"] = cut(params["layers"])
    return out


__all__ = [
    "apply_rope",
    "attention",
    "cache_specs",
    "flash_gate",
    "forward",
    "head_forward",
    "init_params",
    "partition_specs",
    "rope_tables",
    "slice_stage_params",
    "stage_forward",
    "top_k",
    "tp_partition_specs",
    "tp_shardable",
]
