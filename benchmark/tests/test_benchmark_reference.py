"""The plain reference at tiny widths against layers worked out position
by position and head by head in float64 NumPy, from the published
equations (``reference/model.py``'s docstring)."""

import numpy as np
import pytest
import torch

from benchmark.flops import Widths
from benchmark.reference.model import Arch, next_token_logits
from benchmark.weights import make_params


def hf_of(family: str, layers: int) -> dict:
    hf = {"model_type": family, "hidden_size": 16, "intermediate_size": 24,
          "num_hidden_layers": layers, "num_attention_heads": 4,
          "num_key_value_heads": 4 if family == "olmo2" else 2,
          "vocab_size": 40, "rms_norm_eps": 1e-6, "rope_theta": 10000.0}
    if family == "mixtral":
        hf |= {"num_local_experts": 4, "num_experts_per_tok": 2}
    return hf


def np_params(params):
    if isinstance(params, dict):
        return {k: np_params(v) for k, v in params.items()}
    return params.double().numpy()


def rms(x, scale, eps):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * scale


def rope(x, pos, theta):
    """One head's row ``x [hd]`` at position ``pos``: element ``i`` pairs
    with ``i + hd/2``."""
    half = x.shape[0] // 2
    out = np.empty_like(x)
    for i in range(half):
        a = pos / theta ** (i / half)
        c, s = np.cos(a), np.sin(a)
        out[i] = x[i] * c - x[i + half] * s
        out[i + half] = x[i + half] * c + x[i] * s
    return out


def attention(a, at, h, qk_norm):
    T = h.shape[0]
    H, Hkv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    q, k, v = h @ at["wq"], h @ at["wk"], h @ at["wv"]
    if qk_norm:
        q = rms(q, at["q_norm"], a.eps)
        k = rms(k, at["k_norm"], a.eps)
    out = np.zeros((T, H * hd))
    for t in range(T):
        for head in range(H):
            g = head // (H // Hkv)
            qt = rope(q[t, head * hd:(head + 1) * hd], t, a.rope_theta)
            scores = np.array([
                qt @ rope(k[s, g * hd:(g + 1) * hd], s, a.rope_theta)
                for s in range(t + 1)]) / np.sqrt(hd)
            p = np.exp(scores - scores.max())
            p /= p.sum()
            for s in range(t + 1):
                out[t, head * hd:(head + 1) * hd] += \
                    p[s] * v[s, g * hd:(g + 1) * hd]
    return out @ at["wo"]


def silu(x):
    return x / (1 + np.exp(-x))


def mlp(gate, up, down, h):
    return (silu(h @ gate) * (h @ up)) @ down


def by_hand(a, p, tokens):
    x = p["embed"]["tok"][tokens]
    L = p["layers"]
    for i in range(a.n_layers):
        at = {k: v[i] for k, v in L["attn"].items()}
        ln1, ln2 = L["ln1"]["scale"][i], L["ln2"]["scale"][i]
        m = L["mlp"]
        if a.family == "olmo2":
            x = x + rms(attention(a, at, x, True), ln1, a.eps)
            x = x + rms(mlp(m["w_gate"][i], m["w_up"][i], m["w_down"][i],
                            x), ln2, a.eps)
            continue
        x = x + attention(a, at, rms(x, ln1, a.eps), False)
        h = rms(x, ln2, a.eps)
        moe = np.zeros_like(h)
        for t in range(h.shape[0]):
            logit = h[t] @ m["router"][i]
            prob = np.exp(logit - logit.max())
            prob /= prob.sum()
            top = np.argsort(-prob)[:a.top_k]
            w = prob[top] / prob[top].sum()
            for wt, e in zip(w, top):
                moe[t] += wt * mlp(m["w_gate"][i, e], m["w_up"][i, e],
                                   m["w_down"][i, e], h[t])
        x = x + moe
    return rms(x, p["final_norm"]["scale"], a.eps) @ p["lm_head"]


@pytest.mark.parametrize("family", ["olmo2", "mixtral"])
@pytest.mark.parametrize("layers", [1, 2])
def test_reference_matches_the_equations(family, layers):
    hf = hf_of(family, layers)
    params = make_params(Widths.from_hf(hf), family, 2**40 + 3,
                         torch.device("cpu"), dtype=torch.float32)
    a = Arch.from_hf(hf)
    seqs = [[3, 17, 5, 39, 0, 8, 21], [11, 2, 30]]
    rows = [[2, 6], [0, 1, 2]]
    got = next_token_logits(a, params, seqs, rows)
    p = np_params(params)
    for s, r, g in zip(seqs, rows, got):
        want = by_hand(a, p, np.array(s))[r]
        np.testing.assert_allclose(g.double().numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_router_margin_is_the_closest_tie():
    hf = hf_of("mixtral", 2)
    params = make_params(Widths.from_hf(hf), "mixtral", 7,
                         torch.device("cpu"), dtype=torch.float32)
    a = Arch.from_hf(hf)
    margins: list = []
    next_token_logits(a, params, [[1, 2, 3, 4]], [[1, 3]], margins)
    # by hand: each layer's router logits at the sequence's positions
    p = np_params(params)
    L, x = p["layers"], p["embed"]["tok"][[1, 2, 3, 4]]
    want = np.full(4, np.inf)
    for i in range(a.n_layers):
        at = {k: v[i] for k, v in L["attn"].items()}
        x = x + attention(a, at, rms(x, L["ln1"]["scale"][i], a.eps), False)
        h = rms(x, L["ln2"]["scale"][i], a.eps)
        logit = np.sort(h @ L["mlp"]["router"][i], axis=-1)[:, ::-1]
        want = np.minimum(want, logit[:, a.top_k - 1] - logit[:, a.top_k])
        moe = np.zeros_like(h)
        for t in range(4):
            lg = h[t] @ L["mlp"]["router"][i]
            prob = np.exp(lg - lg.max())
            prob /= prob.sum()
            top = np.argsort(-prob)[:a.top_k]
            for wt, e in zip(prob[top] / prob[top].sum(), top):
                moe[t] += wt * mlp(L["mlp"]["w_gate"][i, e],
                                   L["mlp"]["w_up"][i, e],
                                   L["mlp"]["w_down"][i, e], h[t])
        x = x + moe
    np.testing.assert_allclose(margins[0].numpy(), want[[1, 3]], atol=1e-5)
