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

Not ported: pipelined stages (``stage_forward``), ``remat`` and ring
attention (``seq_mesh``) wait for the node/pipeline and training slices;
the tensor-parallel gathers and the ``expert`` mesh axis for the
tensor-parallel slice. Each raises with the slice it waits for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
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


def _moe_mlp(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mixtral-style top-k MoE, dense dispatch: every expert sees every
    token and the outputs combine with the top-k gates (the softmax over
    the chosen experts' float32 router logits, zero elsewhere), as the
    JAX ``_moe_mlp``. ``cfg.moe_dispatch == "sparse"`` routes to the
    capacity-limited dispatch (``parallel/expert.py``)."""
    if cfg.moe_dispatch == "sparse":
        from ..parallel.expert import sparse_moe_mlp

        return sparse_moe_mlp(h, p, cfg)
    router_logits = _mm(h, p["router"]).float()  # [..., E]
    topw, topi = top_k(router_logits, cfg.n_experts_per_tok)
    gates = torch.zeros_like(router_logits).scatter(
        -1, topi, torch.softmax(topw, dim=-1))
    g = torch.einsum("btd,edf->btef", h, p["w_gate"])
    u = torch.einsum("btd,edf->btef", h, p["w_up"])
    y = torch.einsum("btef,efd->bted", _act(g, cfg.act) * u, p["w_down"])
    return torch.einsum("bted,bte->btd", y, gates.to(h.dtype))


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LM head: the tied embedding's transpose, or ``lm_head``, plus the
    optional Gemma-style soft cap."""
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
    B, T = h.shape[:2]
    ap = lp["attn"]
    q = _mm(h, ap["wq"])
    k = _mm(h, ap["wk"])
    v = _mm(h, ap["wv"])
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    if cfg.qk_norm_full:  # OLMo-2: full-projection-dim RMSNorm pre-reshape
        q = _rms_head_norm(q, ap["q_norm"], cfg.norm_eps)
        k = _rms_head_norm(k, ap["k_norm"], cfg.norm_eps)
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
    B, T = attn_raw.shape[:2]
    ap = lp["attn"]
    attn_out = _mm(attn_raw.reshape(B, T, -1), ap["wo"])
    if "bo" in ap:
        attn_out = attn_out + ap["bo"]
    if cfg.norm_position == "post":  # OLMo-2: ln1/ln2 norm sublayer outputs
        x = x + _norm(attn_out, lp["ln1"], cfg)
        x = x + _norm(_mlp(x, lp["mlp"], cfg), lp["ln2"], cfg)
    elif cfg.parallel_residual:  # GPT-NeoX: both branches read the input
        x = x + attn_out + _mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    else:
        x = x + attn_out
        x = x + _mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg)
    return x


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
    """One decoder block. With a cache, this step's k/v land at each
    row's ``write_at`` (in place; int8 mode quantizes them there) and
    attention reads the whole cache — or its first ``kv_upto`` positions,
    which is all a fresh-cache flash prefill reads — dequantized to the
    activation dtype."""
    h = x if cfg.norm_position == "post" else _norm(x, lp["ln1"], cfg)
    q, k, v = _qkv(h, lp, cfg, cos, sin)
    if cache_kv is not None:
        if len(cache_kv) == 4:  # int8 cache: quantize writes, dequant reads
            ck, cv, cks, cvs = cache_kv
            k8, ks = _quant_kv(k)
            v8, vs = _quant_kv(v)
            for c, u in ((ck, k8), (cv, v8), (cks, ks), (cvs, vs)):
                _write_rows(c, u, write_at)
            ck, cv, cks, cvs = (t[:, :kv_upto] for t in cache_kv)
            k_all = (ck.float() * cks).to(x.dtype)
            v_all = (cv.float() * cvs).to(x.dtype)
        else:
            ck, cv = cache_kv
            _write_rows(ck, k.to(ck.dtype), write_at)
            _write_rows(cv, v.to(cv.dtype), write_at)
            k_all, v_all = ck[:, :kv_upto], cv[:, :kv_upto]
    else:
        k_all, v_all = k, v
    impl = attn_fn or attention
    attn_raw = impl(q, k_all.to(q.dtype), v_all.to(q.dtype), mask_bias,
                    _attn_scale(cfg))
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


def _refuse(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported yet — it waits for the {slice_name} slice of "
        "the port"
    )


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
    JAX)."""
    if remat:
        _refuse("remat (activation checkpointing)", "training")
    if seq_mesh is not None:
        _refuse("sequence-parallel ring attention (seq_mesh)", "training")
    B, T = tokens.shape
    dev = tokens.device
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if cache is not None:
        offset = cache.length
    else:
        offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    if positions is None:
        positions = offset.long()[:, None] + torch.arange(T, device=dev)[None]

    x = _embed_tokens(params, tokens.long(), cfg)
    if cfg.pos == "learned":
        # clamped like JAX's out-of-bounds gather (a finished row of the
        # host-driven loop keeps stepping past the table)
        pos_idx = torch.clamp(positions.long(), 0, cfg.max_seq_len - 1)
        x = x + params["embed"]["pos"][pos_idx].to(cfg.dtype)
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

    for i, lp in enumerate(_layers(params)):
        kv = cache.layer_kv(i) if cache is not None else None
        x = _block(x, lp, cfg, cos, sin, bias, kv, offset, attn_fn, kv_upto)
    new_cache = cache
    if cache is not None:
        new_cache = KVCache(
            k=cache.k, v=cache.v,
            length=offset + attn_mask.sum(-1).to(torch.int32),
            k_scale=cache.k_scale, v_scale=cache.v_scale,
        )
    x = _norm(x, params["final_norm"], cfg)
    if return_hidden:
        return x, new_cache
    return _logits(params, x, cfg), new_cache


def stage_forward(*_args, **_kwargs):
    """Pipeline stages are not ported yet: raises."""
    _refuse("stage_forward (pipelined stages)", "node/pipeline")


__all__ = [
    "apply_rope",
    "attention",
    "flash_gate",
    "forward",
    "init_params",
    "rope_tables",
    "stage_forward",
    "top_k",
]
