"""Plain float32 forward passes of OLMo-2 and Mixtral, in plain PyTorch.

Written from the published descriptions (the Hugging Face ``olmo2`` and
``mixtral`` model code): no kernel, no cache, no batching of requests, no
code or table of the program under test. Weights are the benchmark's own
tree (``benchmark/weights.py`` says which leaf is which), read a layer at
a time and widened to float32 there, so a model that fills most of the
card in bf16 still fits beside its float32 layer. TF32 is off: every
product runs in float32.

- OLMo-2: ``h = x``; ``q = RMSNorm(h Wq)``, ``k = RMSNorm(h Wk)`` over
  the whole projections, ``v = h Wv``; rotary embedding; causal
  attention; ``x = x + RMSNorm_attn(o Wo)``; ``x = x +
  RMSNorm_ffn(down(silu(gate(x)) * up(x)))``.
- Mixtral: ``x = x + attn(RMSNorm_in(x))`` with grouped kv heads; ``h =
  RMSNorm_post(x)``; router softmax over all experts, the top ``k``
  weights renormalised to sum to one; ``x = x + sum_e w_e *
  down_e(silu(gate_e(h)) * up_e(h))`` over the chosen experts.
- Both: a final RMSNorm and the untied LM head.

Rotary angles are taken in float64 and rounded once to float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Arch:
    family: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    eps: float
    rope_theta: float
    n_experts: int = 0
    top_k: int = 0

    @classmethod
    def from_hf(cls, hf: dict) -> "Arch":
        heads = int(hf["num_attention_heads"])
        return cls(
            family=str(hf["model_type"]),
            d_model=int(hf["hidden_size"]),
            n_layers=int(hf["num_hidden_layers"]),
            n_heads=heads,
            n_kv_heads=int(hf.get("num_key_value_heads") or heads),
            head_dim=int(hf.get("head_dim") or hf["hidden_size"] // heads),
            vocab=int(hf["vocab_size"]),
            eps=float(hf["rms_norm_eps"]),
            rope_theta=float(hf["rope_theta"]),
            n_experts=int(hf.get("num_local_experts") or 0),
            top_k=int(hf.get("num_experts_per_tok") or 0),
        )


def strict_float32() -> None:
    """Matrix products in full float32 (no TF32) from here on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x [T, H, hd]`` at positions ``0 .. T-1`` (the half-split
    pairing: element ``i`` with ``i + hd/2``)."""
    T, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """``q [T, H, hd]``, ``k``/``v [T, Hkv, hd]``; query head ``h`` reads
    kv head ``h // (H / Hkv)``. Returns ``[T, H * hd]``."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    del scores
    return torch.einsum("hts,shd->thd", probs, v).reshape(T, H * hd)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _attention_block(a: Arch, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """The attention sublayer of one sequence ``h [T, d]``, before the
    output norm (OLMo-2) or the residual add (Mixtral)."""
    at = lp["attn"]
    q, k, v = h @ at["wq"], h @ at["wk"], h @ at["wv"]
    if a.family == "olmo2":
        q = rms_norm(q, at["q_norm"], a.eps)
        k = rms_norm(k, at["k_norm"], a.eps)
    T = h.shape[0]
    q = rotary(q.reshape(T, a.n_heads, a.head_dim), a.rope_theta)
    k = rotary(k.reshape(T, a.n_kv_heads, a.head_dim), a.rope_theta)
    v = v.reshape(T, a.n_kv_heads, a.head_dim)
    return causal_attention(q, k, v) @ at["wo"]


def _dense_mlp(mp: dict, h: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(h @ mp["w_gate"])
            * (h @ mp["w_up"])) @ mp["w_down"]


def _moe(a: Arch, raw_mlp: dict, i: int, h: torch.Tensor,
         margin: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k routed experts of layer ``i`` over tokens ``h [N, d]``; each
    expert's weights are widened only while it runs. ``margin [N]``, when
    given, is lowered to each token's router-logit gap between its k-th
    and (k+1)-th expert, where the choice of experts is closest to a tie."""
    logits = h @ _f32(raw_mlp["router"][i])
    if margin is not None and a.top_k < a.n_experts:
        top = torch.topk(logits, a.top_k + 1, dim=-1).values
        torch.minimum(margin, top[:, -2] - top[:, -1], out=margin)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, a.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(a.n_experts):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        mp = {k: _f32(raw_mlp[k][i, e]) for k in ("w_gate", "w_up", "w_down")}
        out.index_add_(0, rows, top_w[rows, slot, None] * _dense_mlp(mp, h[rows]))
    return out


def _layer(params: dict, i: int, skip: tuple = ()) -> dict:
    """Layer ``i``'s leaves widened to float32 (leaves under ``skip``
    stay as stored)."""
    def take(node, name=""):
        if isinstance(node, dict):
            return {k: take(v, k) for k, v in node.items() if k not in skip}
        return _f32(node[i])
    return take(params["layers"])


@torch.no_grad()
def next_token_logits(a: Arch, params: dict, seqs: list[list[int]],
                      rows: list[list[int]], margins: list | None = None
                      ) -> list[torch.Tensor]:
    """For each token sequence ``seqs[n]``, the float32 logits ``[len(rows
    [n]), V]`` the model gives at positions ``rows[n]`` (the logits of the
    token after each), computed layer by layer over every sequence. A MoE
    model appends to ``margins``, when given, each sequence's router
    margin at those positions (``_moe``), least over the layers."""
    strict_float32()
    dev = params["embed"]["tok"].device
    xs = [_f32(params["embed"]["tok"][torch.tensor(s, device=dev)])
          for s in seqs]
    bounds = [0]
    for s in seqs:
        bounds.append(bounds[-1] + len(s))
    margin = (torch.full((bounds[-1],), float("inf"), device=dev)
              if margins is not None and a.n_experts else None)
    for i in range(a.n_layers):
        lp = _layer(params, i, skip=("mlp",) if a.n_experts else ())
        ln1, ln2 = lp["ln1"]["scale"], lp["ln2"]["scale"]
        if a.family == "olmo2":
            xs = [x + rms_norm(_attention_block(a, lp, x), ln1, a.eps)
                  for x in xs]
            x = torch.cat(xs)
            x = x + rms_norm(_dense_mlp(lp["mlp"], x), ln2, a.eps)
        else:
            xs = [x + _attention_block(a, lp, rms_norm(x, ln1, a.eps))
                  for x in xs]
            x = torch.cat(xs)
            h = rms_norm(x, ln2, a.eps)
            x = x + (_moe(a, params["layers"]["mlp"], i, h, margin)
                     if a.n_experts
                     else _dense_mlp(lp["mlp"], h))
        xs = [x[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
        del lp, x
    head = _f32(params["lm_head"])
    fn = _f32(params["final_norm"]["scale"])
    if margin is not None:
        margins += [margin[lo:hi][torch.tensor(r, device=dev)]
                    for lo, hi, r in zip(bounds, bounds[1:], rows)]
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[torch.tensor(r, device=dev)], fn, a.eps)
        out.append(h @ head)
    return out
