"""Seeded weights, made on the device in the type they are served in.

The tree is the layout the program loads (``[in, out]`` matrices stacked
``[L, ...]`` over layers) and the plain reference reads the same tensors.
What each leaf is, in the published models' terms:

- ``embed.tok`` ``[V, d]``: the token embedding.
- ``layers.ln1.scale`` / ``layers.ln2.scale`` ``[L, d]``: Mixtral's
  ``input_layernorm`` / ``post_attention_layernorm`` (norms of the
  sublayer inputs); OLMo-2's ``post_attention_layernorm`` /
  ``post_feedforward_layernorm`` (norms of the sublayer outputs).
- ``layers.attn.wq/wk/wv/wo``; OLMo-2 adds ``q_norm`` ``[L, H*hd]`` and
  ``k_norm`` ``[L, Hkv*hd]``, RMSNorms over the whole projections.
- ``layers.mlp``: ``w_gate``, ``w_up`` ``[L, d, f]``, ``w_down``
  ``[L, f, d]``; Mixtral: ``router`` ``[L, d, E]`` and the experts'
  ``w_gate``, ``w_up`` ``[L, E, d, f]`` and ``w_down`` ``[L, E, f, d]``.
- ``final_norm.scale`` ``[d]``, ``lm_head`` ``[d, V]``.

Matrices are normal with standard deviation ``fan_in ** -0.5`` (the
embedding 0.02), norm scales ``1 + 0.1 * normal``, so that a norm whose
scale is dropped shows in the comparison. One generator on the device
draws every leaf in a fixed order, a layer of a leaf per call.
"""

from __future__ import annotations

import torch

from .flops import Widths


def seed_bits(seed: int) -> int:
    """A ``--seed`` as the unsigned 64-bit value generators accept."""
    return int(seed) % (1 << 64)


def make_params(w: Widths, family: str, seed: int, device,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The parameter tree of ``w`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    L, d, f, V = w.n_layers, w.d_model, w.d_ff, w.vocab
    q_dim, kv_dim = w.n_heads * w.head_dim, w.n_kv_heads * w.head_dim

    def normal(shape, std: float, mean: float = 0.0) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=device)
        for part in (t if len(shape) > 2 else (t,)):
            part.normal_(mean, std, generator=gen)
        return t

    def dense(*shape, std=None):
        return normal(shape, std if std is not None else shape[-2] ** -0.5)

    def scale(*shape):
        return normal(shape, 0.1, mean=1.0)

    attn = {"wq": dense(L, d, q_dim), "wk": dense(L, d, kv_dim),
            "wv": dense(L, d, kv_dim), "wo": dense(L, q_dim, d)}
    if family == "olmo2":
        attn["q_norm"] = scale(L, q_dim)
        attn["k_norm"] = scale(L, kv_dim)
    if w.n_experts:
        E = w.n_experts
        mlp = {"router": dense(L, d, E), "w_gate": dense(L, E, d, f),
               "w_up": dense(L, E, d, f), "w_down": dense(L, E, f, d)}
    else:
        mlp = {"w_gate": dense(L, d, f), "w_up": dense(L, d, f),
               "w_down": dense(L, f, d)}
    return {
        "embed": {"tok": dense(V, d, std=0.02)},
        "layers": {"ln1": {"scale": scale(L, d)}, "attn": attn,
                   "ln2": {"scale": scale(L, d)}, "mlp": mlp},
        "final_norm": {"scale": scale(d)},
        "lm_head": dense(d, V),
    }
