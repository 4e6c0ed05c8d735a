"""Decoder building blocks (port of ``tensorlink_tpu/models/transformer.py``).

The pieces the paged serving path needs, with the JAX names and math:
``init_params`` (the same parameter tree, leaf names and stacked ``[L, …]``
shapes), the norms, rope, the activation, the dense MLP and the LM head.
Parameters are a plain nested dict of tensors — no ``nn.Module`` — so a
JAX tree moves over leaf for leaf (``convert.py::params_from_jax``).
Norm statistics and rope run in float32 and cast back to the activation
dtype, as in the JAX package.

Not in this slice: the dense ``forward``/``stage_forward`` path with its
flash prefill, MoE, and the tensor-parallel gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.devices import resolve_device
from .base import ModelConfig
from .quant import matmul as _mm


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
    device — then cast to ``dtype``. ``device=None`` is the CUDA card."""
    if cfg.moe:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet — it waits for the MoE "
            "slice of the port"
        )
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

    if cfg.mlp == "gated":
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
    """Dense MLP block (gated or fused)."""
    if cfg.moe:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet — it waits for the MoE "
            "slice of the port"
        )
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


__all__ = [
    "apply_rope",
    "init_params",
    "rope_tables",
]
