"""Sparse MoE dispatch: capacity-factor top-k routing, on one device or
over an ``expert`` mesh axis (port of ``tensorlink_tpu/parallel/expert.py``).

The dense dispatch (``models/transformer.py::_moe_mlp``) runs every
token through every expert. This is the GShard/Switch formulation: tokens
scatter into per-expert capacity buffers ``[E, C, d]`` with one-hot
dispatch einsums, each expert runs its FFN on its buffer, and the results
combine back weighted by the router.

Tokens dispatch in independent groups; each expert takes at most ``C =
ceil(g · K · capacity_factor / E)`` token-slots per group of ``g``
tokens, and an overflowing slot is dropped (its combine weight is lost,
no renormalisation). With ``capacity_factor = E/K`` nothing can drop and
the result equals the dense dispatch.

Over an ``expert`` mesh axis (:func:`placed_moe_mlp`, run by
``models/sharded.py`` for a tree placed by ``partition_specs(
expert_axis="expert")``) each expert shard holds a block of ``E/ep``
experts. The router is replicated, so every distinct device routes the
tokens it holds with the same capacity and drop order; each expert shard
takes its ``[G, E/ep, C, d]`` block of the dispatched tokens with
``to_device``, runs its FFN there, and the blocks come back for the
combine in expert order — the all-to-alls of the JAX package's GSPMD
lowering, written out. The dense dispatch runs over the same shards:
each computes its own experts' outputs for every token, and the parts sum
in a fixed shard order.
"""

from __future__ import annotations

import math

import torch

from .mesh import to_device

__all__ = ["expert_capacity", "placed_moe_mlp", "sparse_moe_mlp",
           "topk_capacity_dispatch"]


def expert_capacity(
    n_tokens: int, n_experts: int, k: int, capacity_factor: float
) -> int:
    """Per-expert token-slot budget ``C`` (≥1, ≤ n_tokens)."""
    c = int(math.ceil(n_tokens * k * capacity_factor / n_experts))
    return max(1, min(c, n_tokens))


def topk_capacity_dispatch(
    router_logits: torch.Tensor,  # [..., S, E] float32
    k: int,
    capacity: int,
):
    """Dispatch and combine tensors for capacity-limited top-k routing.

    Returns ``(dispatch, combine)``, both ``[..., S, E, C]`` float32:
    ``dispatch`` is 0/1 (token ``s`` holds slot ``c`` of expert ``e``) and
    ``combine = dispatch · softmax(top-k router weights)``. Leading axes
    are independent groups.

    Slots go by (k-rank, token order): every rank-0 choice claims capacity
    before any rank-1 choice, so overflow drops the lower-weighted
    assignments first."""
    from ..models.transformer import top_k

    E = router_logits.shape[-1]
    topw, topi = top_k(router_logits, k)
    topw = torch.softmax(topw, dim=-1)  # [..., S, K] over the chosen
    dev = router_logits.device
    lead = router_logits.shape[:-1]
    dispatch = torch.zeros((*lead, E, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((*lead[:-1], 1, E), dtype=torch.int64, device=dev)
    experts = torch.arange(E, device=dev)
    slots = torch.arange(capacity, device=dev)
    for r in range(k):
        e_r = topi[..., r]  # [..., S] expert chosen at rank r
        mask = (e_r[..., None] == experts).long()  # [..., S, E]
        # the slot each token would take in its chosen expert
        pos = counts + torch.cumsum(mask, dim=-2) - 1  # [..., S, E]
        slot = torch.gather(pos, -1, e_r[..., None])[..., 0]  # [..., S]
        # a slot past the capacity matches no column: the token drops
        oh_slot = (slot[..., None] == slots).float()  # [..., S, C]
        d_r = mask.float()[..., None] * oh_slot[..., None, :]
        dispatch = dispatch + d_r
        combine = combine + d_r * topw[..., r, None, None]
        counts = counts + mask.sum(dim=-2, keepdim=True)
    return dispatch, combine


def _n_groups(S: int, group_size: int) -> int:
    """Largest group count whose groups (a) divide S and (b) are at least
    ``group_size`` tokens — one group when S is small."""
    g = max(1, S // max(group_size, 1))
    while S % g:
        g -= 1
    return g


def _route(h: torch.Tensor, router, cfg, capacity_factor=None) -> tuple:
    """The tokens ``h`` ``[B, T, d]`` routed in dispatch groups:
    ``(combine [G, gs, E, C], xe [G, E, C, d])``, ``xe`` each expert's
    capacity buffer."""
    from ..models.quant import matmul

    B, T, d = h.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    S = B * T
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    G = _n_groups(S, cfg.moe_group_size)
    gs = S // G  # tokens per dispatch group
    C = expert_capacity(gs, E, K, cf)

    x = h.reshape(G, gs, d)
    router_logits = matmul(x, router).float()  # [G, gs, E]
    dispatch, combine = topk_capacity_dispatch(router_logits, K, C)
    # scatter tokens to per-group expert buffers
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), x)
    return combine, xe


def _expert_ffn(xe: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """The FFN of the experts ``p`` holds over their buffers ``xe``
    ``[G, n, C, d]``."""
    from ..models.transformer import _act

    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    return torch.einsum("gecf,efd->gecd", _act(g, cfg.act) * u, p["w_down"])


def _combine(combine: torch.Tensor, y: torch.Tensor, shape) -> torch.Tensor:
    """Gather the experts' outputs back, weighted by the router."""
    out = torch.einsum("gsec,gecd->gsd", combine.to(y.dtype), y)
    return out.reshape(shape)


def sparse_moe_mlp(
    h: torch.Tensor,  # [B, T, d]
    p: dict,  # router [d, E], w_gate/w_up [E, d, f], w_down [E, f, d]
    cfg,
    *,
    capacity_factor: float | None = None,
) -> torch.Tensor:
    """Drop-in for the dense ``_moe_mlp`` (``models/transformer.py``
    routes here when ``cfg.moe_dispatch == "sparse"``). Tokens dispatch
    in groups of about ``cfg.moe_group_size`` (GShard's grouping: the
    one-hot einsums grow with the group, not the whole batch), with the
    capacity per group."""
    combine, xe = _route(h, p["router"], cfg, capacity_factor)
    return _combine(combine, _expert_ffn(xe, p, cfg), h.shape)


def placed_moe_mlp(h: dict, routers: dict, shards: list, cfg, *,
                   n_tensor: int = 1) -> dict:
    """A MoE layer over its expert (and tensor) shards, in
    ``cfg.moe_dispatch``'s form, the output whole on every device of
    ``h``.

    ``h`` holds the layer's input whole on each distinct device
    (``{device: [B, T, d]}``) and ``routers`` the replicated router
    there. ``shards`` is ``[(device, p), …]`` in mesh order, expert-major
    and tensor-minor: shard ``k`` holds the experts of block ``k //
    n_tensor`` (``p["w_gate"]`` ``[E/ep, d, f/tp]``), its hidden columns
    ``k % n_tensor``.

    Dense: each device's gates (once per device), each shard's gated
    output over every token from its own device's input, the parts summed
    in shard order onto every device. Sparse: each device routes (once
    per device) with the capacity of the whole layer, each shard takes
    its block of the buffers, runs its FFN and the tensor shards' partial
    outputs sum in order; the expert blocks join in expert order on every
    device for the combine."""
    from ..models.transformer import _moe_block, _moe_gates, _tp_sum

    n_local = shards[0][1]["w_gate"].shape[0]

    def block(k: int) -> slice:
        e0 = (k // n_tensor) * n_local
        return slice(e0, e0 + n_local)

    if cfg.moe_dispatch != "sparse":
        gates = {d: _moe_gates(x, routers[d], cfg) for d, x in h.items()}
        parts = [_moe_block(h[d], p, gates[d][..., block(k)], cfg)
                 for k, (d, p) in enumerate(shards)]
        return {d: _tp_sum(parts, d) for d in h}
    routed = {d: _route(x, routers[d], cfg) for d, x in h.items()}
    ys = [_expert_ffn(to_device(routed[d][1][:, block(k)], d), p, cfg)
          for k, (d, p) in enumerate(shards)]
    n_blocks = len(shards) // n_tensor
    out = {}
    for d, x in h.items():
        y = torch.cat([_tp_sum(ys[b * n_tensor:(b + 1) * n_tensor], d)
                       for b in range(n_blocks)], dim=1)
        out[d] = _combine(routed[d][0], y, x.shape)
    return out
