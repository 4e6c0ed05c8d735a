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

__all__ = ["WholeBatchDispatch", "capacity_slots", "expert_capacity",
           "placed_moe_mlp", "sparse_moe_mlp", "topk_capacity_dispatch"]


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


def capacity_slots(topi: torch.Tensor, capacity: int,
                   n_experts: int) -> torch.Tensor:
    """Each (token, rank)'s slot in its chosen expert's buffer of its
    dispatch group: ``topi`` ``[G, gs, K]`` (the top-k choices) →
    ``[G, gs, K]`` int64, a slot at or past ``capacity`` dropped.
    :func:`topk_capacity_dispatch`'s arithmetic: every rank-0 choice
    claims capacity before any rank-1 choice, in token order."""
    experts = torch.arange(n_experts, device=topi.device)
    counts = torch.zeros((topi.shape[0], 1, n_experts), dtype=torch.int64,
                         device=topi.device)
    out = []
    for r in range(topi.shape[-1]):
        e_r = topi[..., r]
        mask = (e_r[..., None] == experts).long()  # [G, gs, E]
        pos = counts + torch.cumsum(mask, dim=-2) - 1
        out.append(torch.gather(pos, -1, e_r[..., None])[..., 0])
        counts = counts + mask.sum(dim=-2, keepdim=True)
    return torch.stack(out, dim=-1)


class WholeBatchDispatch:
    """The sparse dispatch of a forward whose rows run apart in blocks (a
    placed forward's (data × fsdp) groups), grouped as JAX's GSPMD step
    groups them: ``_n_groups(B·T, moe_group_size)`` groups over the whole
    batch's flattened tokens in row order, each with the whole batch's
    capacity and slots by (k-rank, token order) — a group may span
    blocks. Per MoE layer, each block's top-k choices (``[S_b, K]``
    integers, :meth:`choose`) come together in block order, the slots are
    computed once (:meth:`settle`), and each block then dispatches its
    own tokens into its groups' buffers with those slots (:meth:`route`;
    another block's slots in a shared group stay empty there, and every
    expert runs row by row, so each token's output is the whole group's).
    A train step settles every layer in a forward without gradients
    (``models/sharded.py::dispatch_plan``) and replays the slots in each
    block's differentiated run; only the router's weights of the chosen
    experts carry a gradient, as in the whole-batch dispatch."""

    def __init__(self, cfg, seq_len: int, block_rows: list,
                 capacity_factor: float | None = None):
        self.E, self.K = cfg.n_experts, cfg.n_experts_per_tok
        S = sum(block_rows) * seq_len
        cf = (capacity_factor if capacity_factor is not None
              else cfg.moe_capacity_factor)
        self.G = _n_groups(S, cfg.moe_group_size)
        self.gs = S // self.G
        self.C = expert_capacity(self.gs, self.E, self.K, cf)
        self.lo = [sum(block_rows[:k]) * seq_len
                   for k in range(len(block_rows))]
        self.n_tokens = [b * seq_len for b in block_rows]
        self._topi: dict = {}  # layer -> {block: [S_b, K]}
        self._slots: dict = {}  # layer -> [[S_b, K] per block]

    def choose(self, layer: int, block: int, h: torch.Tensor, router):
        """Record block ``block``'s top-k choices at ``layer`` from its MLP
        input ``h`` ``[b, T, d]``."""
        from ..models.quant import matmul
        from ..models.transformer import top_k

        logits = matmul(h.reshape(-1, h.shape[-1]), router).float()
        self._topi.setdefault(layer, {})[block] = top_k(
            logits, self.K)[1].detach()

    def settle(self, layer: int) -> None:
        """The slots of every block at ``layer``, from their choices in
        block order (on the first block's device)."""
        got = self._topi.pop(layer)
        dev = got[0].device
        topi = torch.cat([to_device(got[k], dev) for k in range(len(got))])
        slots = capacity_slots(topi.reshape(self.G, self.gs, self.K),
                               self.C, self.E).reshape(-1, self.K)
        self._slots[layer] = [
            (got[k], slots[self.lo[k]:self.lo[k] + self.n_tokens[k]])
            for k in range(len(got))]

    def settled(self, layer: int) -> bool:
        return layer in self._slots

    def route(self, layer: int, block: int, h: torch.Tensor, router):
        """Block ``block``'s tokens ``h`` routed with the settled slots:
        ``(combine [n_g, gs, E, C], xe [n_g, E, C, d], unpad)`` over the
        dispatch groups its tokens fall in, its own combine weights (the
        softmax over its router logits at the chosen experts) carrying
        the router's gradient."""
        from ..models.quant import matmul

        topi, slot = self._slots[layer][block]
        dev = h.device
        topi, slot = to_device(topi, dev), to_device(slot, dev)
        shape = h.shape
        d = shape[-1]
        x = h.reshape(-1, d)
        Sb = x.shape[0]
        logits = matmul(x, router).float()
        topw = torch.softmax(torch.gather(logits, -1, topi), dim=-1)
        lo = self.lo[block]
        g0, g1 = lo // self.gs, (lo + Sb - 1) // self.gs + 1
        off, n_pad = lo - g0 * self.gs, (g1 - g0) * self.gs
        experts = torch.arange(self.E, device=dev)
        slots = torch.arange(self.C, device=dev)
        dispatch = combine = None
        for r in range(self.K):
            d_r = ((topi[:, r, None] == experts).float()[:, :, None]
                   * (slot[:, r, None] == slots).float()[:, None, :])
            w_r = d_r * topw[:, r, None, None]
            dispatch = d_r if dispatch is None else dispatch + d_r
            combine = w_r if combine is None else combine + w_r

        def pad(t):  # the block's rows at their place in its groups
            t = torch.nn.functional.pad(
                t, (0, 0) * (t.dim() - 1) + (off, n_pad - off - Sb))
            return t.reshape(g1 - g0, self.gs, *t.shape[1:])

        xe = torch.einsum("gsec,gsd->gecd", pad(dispatch).to(x.dtype),
                          pad(x))
        return pad(combine), xe, lambda out: out.reshape(
            -1, d)[off:off + Sb].reshape(shape)


def _expert_ffn(xe: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """The FFN of the experts ``p`` holds over their buffers ``xe``
    ``[G, n, C, d]``."""
    from ..models.transformer import _act

    g = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    return torch.einsum("gecf,efd->gecd", _act(g, cfg.act) * u, p["w_down"])


def _combine(combine: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gather the experts' outputs back, weighted by the router: ``[G,
    gs, d]``."""
    return torch.einsum("gsec,gecd->gsd", combine.to(y.dtype), y)


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
    return _combine(combine, _expert_ffn(xe, p, cfg)).reshape(h.shape)


def placed_moe_mlp(h: dict, routers: dict, shards: list, cfg, *,
                   n_tensor: int = 1, route=None) -> dict:
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
    per device) with the capacity of the whole layer — or, given
    ``route(x, router)``, with the whole batch's slots
    (:meth:`WholeBatchDispatch.route`) — each shard takes its block of
    the buffers, runs its FFN and the tensor shards' partial outputs sum
    in order; the expert blocks join in expert order on every device for
    the combine."""
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
    route = route or (lambda x, router: (*_route(x, router, cfg),
                                         lambda out: out.reshape(x.shape)))
    routed = {d: route(x, routers[d]) for d, x in h.items()}
    ys = [_expert_ffn(to_device(routed[d][1][:, block(k)], d), p, cfg)
          for k, (d, p) in enumerate(shards)]
    n_blocks = len(shards) // n_tensor
    out = {}
    for d in h:
        y = torch.cat([_tp_sum(ys[b * n_tensor:(b + 1) * n_tensor], d)
                       for b in range(n_blocks)], dim=1)
        combine, _, unpad = routed[d]
        out[d] = unpad(_combine(combine, y))
    return out
