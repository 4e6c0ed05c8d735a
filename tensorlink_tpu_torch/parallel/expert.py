"""Sparse MoE dispatch: capacity-factor top-k routing on one device (port
of ``tensorlink_tpu/parallel/expert.py``).

The dense dispatch (``models/transformer.py::_moe_mlp``) runs every token
through every expert. This is the GShard/Switch formulation: tokens
scatter into per-expert capacity buffers ``[E, C, d]`` with one-hot
dispatch einsums, each expert runs its FFN on its buffer, and the results
combine back weighted by the router.

Tokens dispatch in independent groups; each expert takes at most ``C =
ceil(g · K · capacity_factor / E)`` token-slots per group of ``g``
tokens, and an overflowing slot is dropped (its combine weight is lost,
no renormalisation). With ``capacity_factor = E/K`` nothing can drop and
the result equals the dense dispatch.

Placing the experts over an ``expert`` mesh axis (the all-to-alls of the
JAX package's GSPMD lowering) waits for the tensor-parallel slice.
"""

from __future__ import annotations

import math

import torch

__all__ = ["expert_capacity", "sparse_moe_mlp", "topk_capacity_dispatch"]


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
    from ..models.quant import matmul
    from ..models.transformer import _act

    B, T, d = h.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    S = B * T
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    G = _n_groups(S, cfg.moe_group_size)
    gs = S // G  # tokens per dispatch group
    C = expert_capacity(gs, E, K, cf)

    x = h.reshape(G, gs, d)
    router_logits = matmul(x, p["router"]).float()  # [G, gs, E]
    dispatch, combine = topk_capacity_dispatch(router_logits, K, C)
    # scatter tokens to per-group expert buffers
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), x)
    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    y = torch.einsum("gecf,efd->gecd", _act(g, cfg.act) * u, p["w_down"])
    # gather back, weighted by the router
    out = torch.einsum("gsec,gecd->gsd", combine.to(y.dtype), y)
    return out.reshape(B, T, d)
