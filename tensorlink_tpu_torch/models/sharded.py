"""The dense forward over a tree placed on a ``{data, fsdp, expert,
tensor}`` mesh — the port's counterpart of the JAX package's GSPMD path
(``forward`` / ``stage_forward`` over a ``put`` tree, with the flash
prefill run per shard inside ``shard_map``), differentiable, so that the
train step and the worker's BACKWARD run on the placed tree itself.

One controller process runs every shard, as in ``engine/paged.py``'s
tensor-parallel step. The mesh's (data × fsdp) groups each take a block
of the batch's rows — over data × fsdp without a cache when the groups
divide the batch (JAX's activations split over both under GSPMD), over
data alone when the cache splits its batch over ``data`` (the cache does
not split over fsdp, so each fsdp group on its own devices writes its
copy), else every row, once per block and distinct device set — and
within a group shard ``t`` runs its heads: its q/k/v columns, its kv
heads of the cache, its attention (``flash_attention`` over its rows and
``Hq/tp`` query heads when the flash gate passes; no collective:
attention is independent per row and head). Where the tensor axis cannot
split the heads (a head count it does not divide, or qk_norm_full's norm
over the whole projection), each device joins the shards' q/k/v columns
and attends over every head with the cache whole over tensor, as GSPMD
reshards. Every other product follows its weight's placement:

- a weight split along its output columns (the serving specs'
  ``wo``/``w_down``, any ``wq``/``w_gate``, an ``lm_head``) makes each
  shard's columns, reassembled by a fixed-order concatenation;
- a weight split along its input rows (the Megatron specs' ``wo``/
  ``w_down``) makes each shard's partial product, reduced by a
  fixed-order sum, shard 0 first; its whole bias is added once after;
- a tied embedding split along the vocabulary looks each token up in the
  shard that holds its row and makes each shard's logit columns;
- a MoE layer's experts split over ``expert`` (each expert shard holds a
  block of them) and/or their hidden dim over the tensor axis:
  ``parallel/expert.py::placed_moe_mlp`` runs each shard's experts, in
  the dense dispatch each shard's gated outputs for every token summed in
  shard order, in the sparse one (training) each shard's block of the
  dispatched tokens, its hidden-column partials summed in shard order;
- a replicated leaf runs once per distinct device.

Within a (data × fsdp) group each index along ``expert`` is a sub-group
of tensor shards holding the same replicated leaves. Attention, norms,
the router and the residual stream run once per distinct device: a
sub-group whose devices an earlier sub-group of the group already runs
on (every expert shard on one card) reuses that sub-group's activations
and cache, and only its MoE experts run; on distinct cards each
sub-group runs them on its own devices and writes its own copy of the
cache, as GSPMD replicates them.

A leaf split over ``fsdp`` (ZeRO-3, ``partition_specs(fsdp_axis=)``) is
gathered just before its use: each shard joins its fsdp peers' pieces
(the same data and tensor index) with ``to_device`` and a fixed-order
concatenation, one layer at a time, and drops the joined weight after
the block. Under ``remat`` the gather runs inside the checkpointed block
(``torch.utils.checkpoint``, non-reentrant), so autograd saves the
pieces, never a joined weight, and the backward gathers again; the LM
head's gather is checkpointed too.

The products after attention are the tensor-parallel epilogue the paged
serving step runs too (``models/transformer.py::_tp_residual``'s parts
``_tp_pre_mlp`` and ``_tp_mlp``, and ``_tp_logits``, over one
:class:`~.transformer.TPLayout` per sub-group); this module adds the
per-shard attention over the dense cache, the vocabulary-split embedding
lookup, the fsdp gathers and the MoE over the expert shards. Norms, residual
adds, rope and the masks run once per distinct device of a group, on the
whole ``d_model``. The logits or hidden states come back whole on the
mesh's first device (or, for one group's run, on the group's first
device); the cache is written in place, piece by piece, and its
``length`` (a ``[B]`` tensor the host loops read and rewrite) comes back
in the form it came in.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import (
    Sharded,
    full_tree,
    to_device,
    tree_mesh,
)
from .base import KVCache, ModelConfig
from .quant import QTensor
from .transformer import (
    TPLayout,
    _attend,
    _embed_tokens,
    _mask_bias,
    _norm,
    _qkv,
    _rope_dim,
    _tp_gather,
    _tp_logits,
    _tp_mlp,
    _tp_pre_mlp,
    flash_gate,
    rope_tables,
)


def _leaf(x):
    return x.q if isinstance(x, QTensor) else x


def _kind(leaf, ndim_stacked: int, tensor_axis: str | None) -> str:
    """How a (stacked) leaf lies over the tensor axis: ``"rep"``,
    ``"col"`` (its last dimension split) or ``"row"`` (its second to last:
    the contraction rows of a ``[.., in, out]`` weight, or the vocabulary
    rows of the embedding)."""
    leaf = _leaf(leaf)
    if not isinstance(leaf, Sharded) or leaf.grid[0] == 1:
        return "rep"
    if tensor_axis is None or tensor_axis not in (
            (leaf.spec.axis,) if isinstance(leaf.spec.axis, str)
            else leaf.spec.axis):
        raise ValueError(f"a leaf split over {leaf.spec.axis!r}: the dense "
                         f"forward splits leaves over the tensor axis (and "
                         f"fsdp_dim over fsdp) only")
    if leaf.spec.dim == ndim_stacked - 1:
        return "col"
    if leaf.spec.dim == ndim_stacked - 2:
        return "row"
    raise ValueError(f"a leaf split along dim {leaf.spec.dim} of "
                     f"{tuple(leaf.shape)}")


def _view(leaf, j: int | None, layer: int | None) -> torch.Tensor:
    t = leaf if j is None else leaf.shards[j]
    return t if layer is None else t[layer]


class _Placed:
    """A placed tree read for one forward: the mesh's (data × fsdp)
    groups, each of ``ep`` sub-groups (one per index along ``expert``),
    each sub-group a :class:`~.transformer.TPLayout` over its tensor
    shards (with how every weight lies), and each shard's fsdp peers.
    Sub-group ``s = g * ep + e`` is group ``g``'s expert index ``e``.
    ``take(leaf, j, layer)`` reads flattened device ``j``'s piece of a
    placed leaf (layer ``layer`` of a stacked one; ``j`` None for a plain
    tensor): a view by default; the train step passes one that makes each
    piece a leaf of its own for autograd."""

    def __init__(self, params: dict, cfg: ModelConfig, take=None):
        mesh = tree_mesh(params)
        self.mesh = mesh
        self.params = params
        self.take = take or _view
        sizes = mesh.shape
        self.tensor_axis = next(
            (a for a in ("tensor", "tp") if sizes.get(a, 1) > 1), None)
        self.tp = sizes.get(self.tensor_axis, 1) if self.tensor_axis else 1
        self.dp = sizes.get("data", 1)
        self.nf = sizes.get("fsdp", 1)
        self.ep = sizes.get("expert", 1)
        flat = mesh.flat()
        d_idx, f_idx = mesh.axis_index("data"), mesh.axis_index("fsdp")
        e_idx = mesh.axis_index("expert")
        t_idx = (mesh.axis_index(self.tensor_axis) if self.tensor_axis
                 else [0] * mesh.size)
        # sub-group s = (data * nf + fsdp) * ep + expert; its shard t is
        # flattened device groups[s][t], and that shard's fsdp peers (the
        # same data, expert and tensor index, fsdp 0 first) are
        # peers[s][t]
        nf, ep = self.nf, self.ep
        self.groups = [[0] * self.tp for _ in range(self.dp * nf * ep)]
        for j in range(mesh.size):
            self.groups[(d_idx[j] * nf + f_idx[j]) * ep + e_idx[j]][
                t_idx[j]] = j
        self.peers = [[[self.groups[((s // ep // nf) * nf + f) * ep
                                    + s % ep][t] for f in range(nf)]
                       for t in range(self.tp)]
                      for s in range(len(self.groups))]
        self.primary = flat[0]
        ax = self.tensor_axis
        lay = params.get("layers", {})
        attn, mlp = lay.get("attn", {}), lay.get("mlp", {})
        self.n_layers = (_leaf(attn["wq"]).shape[0] if "wq" in attn else 0)
        self.qkv = _kind(attn["wq"], 3, ax) if "wq" in attn else "rep"
        up = mlp.get("w_up", mlp.get("w_gate"))
        nd = 4 if cfg.moe else 3
        kinds = dict(
            wo=_kind(attn["wo"], 3, ax) if "wo" in attn else "rep",
            up=_kind(up, nd, ax) if up is not None else "rep",
            down=_kind(mlp["w_down"], nd, ax) if "w_down" in mlp else "rep",
            tok=_kind(params["embed"]["tok"], 2, ax)
            if "tok" in params.get("embed", {}) else "rep",
            head=_kind(params["lm_head"], 2, ax) if "lm_head" in params
            else "rep")
        # the attention leaves split by output column (q/k/v, their
        # biases, qk_norm_full's scales)
        self.attn_cols = {n for n, leaf in attn.items() if _kind(
            leaf, len(_leaf(leaf).shape), ax) == "col"}
        self.split_heads = _splits_heads(self.qkv, cfg, self.tp)
        if (kinds["up"] == "rep") != (kinds["down"] == "rep"):
            raise ValueError("the MLP's projections are not split together "
                             "over the tensor axis")
        if cfg.moe and kinds["up"] != "rep" and kinds["down"] != "row":
            raise ValueError("a MoE layer splits its experts' hidden dim "
                             "(w_down along its rows)")
        if kinds["tok"] == "col" or kinds["head"] == "row":
            raise ValueError("the embedding splits its vocabulary rows and "
                             "the head its vocabulary columns only")
        # a MoE layer split over expert or tensor runs over its shards
        self.moe_split = cfg.moe and (_check_experts(params, cfg, ep)
                                      or kinds["up"] != "rep")
        self.lays = [TPLayout([flat[j] for j in grp], **kinds)
                     for grp in self.groups]
        # a sparse MoE forward whose row blocks run apart takes the whole
        # batch's slots: the dispatch and each group's block in it
        self.dispatch = None
        self.block_of: dict = {}
        # each sub-group's runner: the first sub-group of its group on
        # the same devices, whose activations it shares
        self.runner = []
        for s in range(len(self.groups)):
            first = s - s % ep
            self.runner.append(next(
                r for r in range(first, s + 1)
                if self.lays[r].devices == self.lays[s].devices))

    @property
    def n_groups(self) -> int:
        return self.dp * self.nf

    def subgroups(self, g: int) -> range:
        """Group ``g``'s sub-groups, expert index 0 first."""
        return range(g * self.ep, (g + 1) * self.ep)

    def runners(self, g: int) -> list:
        """The sub-groups of group ``g`` that run the replicated work."""
        return [s for s in self.subgroups(g) if self.runner[s] == s]

    def _gather(self, leaf, s: int, t: int, layer: int | None):
        """Sub-group ``s`` shard ``t``'s tensor of ``leaf`` (layer
        ``layer`` of a stacked one): its own piece, or, for a leaf split
        over fsdp, its peers' pieces joined in fsdp order on its device."""
        if isinstance(leaf, QTensor):
            return QTensor(q=self._gather(leaf.q, s, t, layer),
                           scale=self._gather(leaf.scale, s, t, layer))
        j = self.groups[s][t]
        if not isinstance(leaf, Sharded):
            return self.take(leaf, None, layer)
        if leaf.n_fsdp == 1:
            return self.take(leaf, j, layer)
        dev = leaf.shards[j].device
        parts = [to_device(self.take(leaf, p, layer), dev)
                 for p in self.peers[s][t]]
        dim = leaf.spec.fsdp_dim - (0 if layer is None else 1)
        return torch.cat(parts, dim=dim)

    def _tree(self, node, s: int, t: int, layer: int | None):
        if isinstance(node, dict):
            return {k: self._tree(v, s, t, layer) for k, v in node.items()}
        return self._gather(node, s, t, layer)

    def layer(self, s: int, i: int, part: str | None = None) -> list:
        """Sub-group ``s``'s layer ``i`` (its ``part`` sub-tree alone,
        e.g. ``"mlp"``, when given): each shard's parameter dict, joined
        over fsdp."""
        node = self.params["layers"]
        node = node if part is None else node[part]
        return [self._tree(node, s, t, i) for t in range(self.tp)]

    def top(self, s: int, names) -> list:
        """Sub-group ``s``'s leaves outside the layers among ``names``
        (embed, final_norm, lm_head): each shard's dict, joined over
        fsdp."""
        sub = {k: self.params[k] for k in names if k in self.params}
        return [self._tree(sub, s, t, None) for t in range(self.tp)]


def _check_experts(params: dict, cfg: ModelConfig, ep: int) -> bool:
    """Whether the tree splits its MoE experts over ``expert``: only the
    experts' ``w_gate``/``w_up``/``w_down`` may split over it, along
    their expert dimension, and then all three ``ep`` ways (a tree the
    axis leaves whole replicates over it)."""
    split = {}
    for path, leaf in _leaves(params):
        leaf = _leaf(leaf)
        if not isinstance(leaf, Sharded) or leaf.n_expert == 1:
            continue
        name = path[-1]
        if not (cfg.moe and path[:2] == ("layers", "mlp")
                and name in ("w_gate", "w_up", "w_down")
                and leaf.spec.expert_dim == 1):
            raise ValueError(f"{'/'.join(path)} splits over expert: only "
                             f"the MoE experts split, along their expert "
                             f"dimension")
        split[name] = leaf.n_expert
    if split and (set(split) != {"w_gate", "w_up", "w_down"}
                  or set(split.values()) != {ep}):
        raise ValueError(f"the experts split {split} over expert={ep}")
    return bool(split)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def _splits_heads(qkv: str, cfg: ModelConfig, tp: int) -> bool:
    """Whether each tensor shard attends over its own heads: q/k/v split by
    column, both head counts divided by the axis, and no norm over the
    whole projection (qk_norm_full). Else every device joins the shards'
    projection columns and attends over all heads, as GSPMD reshards."""
    return (qkv == "col" and not cfg.n_heads % tp
            and not cfg.n_kv_heads % tp and not cfg.qk_norm_full)


def head_axis(params: dict, cfg: ModelConfig) -> str | None:
    """The axis a placed tree's forward splits the heads (and so the
    cache's kv heads) over, or None."""
    pl = _Placed(params, cfg)
    return pl.tensor_axis if pl.split_heads else None


def _joined_attn(pl: _Placed, lps: list, lay: TPLayout, device) -> dict:
    """A group's layer attention leaves whole on ``device`` (``lps[t]``
    shard ``t``'s): the column-split ones joined from the shards (codes
    and scales of a quantized one alike)."""
    out = dict(lps[lay.first[device]]["attn"])
    for n in pl.attn_cols:
        pieces = [lp["attn"][n] for lp in lps]
        if isinstance(pieces[0], QTensor):
            out[n] = QTensor(q=_tp_gather([p.q for p in pieces], device),
                             scale=_tp_gather([p.scale for p in pieces],
                                              device))
        else:
            out[n] = _tp_gather(pieces, device)
    return out


def _row_blocks(pl: _Placed, cache: KVCache | None, B: int) -> int:
    """How many blocks of rows the groups split the batch into: the data
    blocks of a cache that splits its batch over ``data``; without a
    cache one block per group when the groups divide the batch, else per
    data group when ``data`` divides it (JAX's rule: a batch it does not
    divide replicates, and nothing raises); else 1."""
    if cache is not None:
        k = cache.k
        return pl.dp if isinstance(k, Sharded) and k.grid[1] > 1 else 1
    if B % (pl.dp * pl.nf) == 0:
        return pl.dp * pl.nf
    return pl.dp if pl.dp > 1 and B % pl.dp == 0 else 1


def _cache_piece(cache: KVCache, j: int, i: int) -> tuple:
    """Shard ``j``'s layer-``i`` views of the cache's fields."""
    out = []
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is None:
            continue
        out.append((t.shards[j] if isinstance(t, Sharded) else t)[i])
    return tuple(out)


def _check_cache(cache: KVCache, pl: _Placed, blocks: int) -> None:
    k = cache.k
    if not isinstance(k, Sharded):
        raise ValueError("a placed tree runs over a placed cache "
                         "(models/transformer.py::cache_specs)")
    if k.n_fsdp > 1:
        raise ValueError("the cache does not split over fsdp")
    heads = k.grid[0] > 1
    if heads != pl.split_heads:
        raise ValueError(f"the cache splits its kv heads {heads}, the "
                         f"forward its heads {pl.split_heads}")
    if heads and (k.spec.dim != 3 or k.grid[0] != pl.tp):
        raise ValueError(f"the cache splits dim {k.spec.dim} "
                         f"{k.grid[0]} ways")
    if blocks > 1 and k.spec.data_dim != 1:
        raise ValueError(f"the cache splits dim {k.spec.data_dim} over data")


def _embed(pl: _Placed, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, g: int) -> dict:
    """Each distinct device's embedding of ``tokens``: a vocabulary-split
    table looks each token up in the shard holding its row."""
    lay = pl.lays[g]
    shards = pl.top(g, ("embed",))
    looked = []
    if lay.tok != "rep":
        # each shard looks up the tokens its vocabulary rows hold, on its
        # own device (a token outside them reads a clamped row, unused)
        for t, sh in enumerate(shards):
            tab = sh["embed"]["tok"]
            n = tab.shape[0]
            local = to_device(tokens, tab.device).long() - t * n
            looked.append((local, tab[torch.clamp(local, 0, n - 1)], n))
    out = {}
    for d, i in lay.first.items():
        if lay.tok == "rep":
            x = _embed_tokens(shards[i], to_device(tokens, d).long(), cfg)
        else:
            x = None
            for local, rows, n in looked:
                local, rows = to_device(local, d), to_device(rows, d)
                hit = (local >= 0) & (local < n)
                x = rows if x is None else torch.where(hit[..., None], rows,
                                                       x)
            x = x.to(cfg.dtype)
            if cfg.embed_scale:
                x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype,
                                     device=d)
        if cfg.pos == "learned":
            pos_idx = torch.clamp(to_device(positions, d).long(), 0,
                                  cfg.max_seq_len - 1)
            x = x + shards[i]["embed"]["pos"][pos_idx].to(cfg.dtype)
        out[d] = x
    return out


def _block(pl: _Placed, xs: dict, cfg: ModelConfig, g: int, rope: dict,
           bias: dict, cache: KVCache | None, write_at: dict, attn_fn,
           kv_upto, i: int) -> dict:
    """Decoder block ``i`` over group ``g``. ``xs`` holds the residual
    stream of each sub-group that runs (``{s: {device: x}}``). Each runs
    its weights gathered (each shard's, joined over fsdp), each shard's
    heads — or, where the heads do not split, all of them once per
    distinct device from the joined q/k/v columns, each device writing
    its own copy of the cache — and the tensor-parallel epilogue up to the
    MLP (:func:`~.transformer._tp_pre_mlp`). A split MoE layer, or any
    MoE layer with the whole batch's dispatch, then runs over every
    sub-group's shards (:func:`_expert_mlp`), any other MLP per sub-group
    (:func:`~.transformer._tp_mlp`)."""
    return _block_post(pl, *_block_pre(pl, xs, cfg, g, rope, bias, cache,
                                       write_at, attn_fn, kv_upto, i),
                       cfg, g, i)


def _block_pre(pl: _Placed, xs: dict, cfg: ModelConfig, g: int, rope: dict,
               bias: dict, cache: KVCache | None, write_at: dict, attn_fn,
               kv_upto, i: int) -> tuple:
    """:func:`_block` up to the MLP: ``(pre, lps_of)``, each running
    sub-group's ``(h, finish)`` and its layer's parameters."""
    pre, lps_of = {}, {}
    for s in pl.runners(g):
        x = xs[s]
        lps = lps_of[s] = pl.layer(s, i)
        lay, group = pl.lays[s], pl.groups[s]
        h = x if cfg.norm_position == "post" else {
            d: _norm(x[d], lps[t]["ln1"], cfg) for d, t in lay.first.items()}
        split = pl.split_heads
        outs = {}
        for t in (range(lay.tp) if split else lay.first.values()):
            d = lay.devices[t]
            lp = lps[t] if split or pl.qkv == "rep" else {
                "attn": _joined_attn(pl, lps, lay, d)}
            q, k, v = _qkv(h[d], lp, cfg, *rope[d])
            kv = (_cache_piece(cache, group[t], i) if cache is not None
                  else None)
            outs[t] = _attend(q, k, v, cfg, bias[d], kv, write_at[d],
                              attn_fn, kv_upto)
        attn = ([outs[t] for t in range(lay.tp)] if split
                else {lay.devices[t]: a for t, a in outs.items()})
        pre[s] = _tp_pre_mlp(x, attn, lps, cfg, lay)
    return pre, lps_of


def _block_post(pl: _Placed, pre: dict, lps_of: dict, cfg: ModelConfig,
                g: int, i: int) -> dict:
    """:func:`_block` from the MLP on."""
    hs = {s: h for s, (h, _) in pre.items()}
    if pl.moe_split or (cfg.moe and pl.dispatch is not None):
        m = _expert_mlp(pl, g, i, hs, lps_of, cfg)
    else:
        m = {s: _tp_mlp(h, [lp["mlp"] for lp in lps_of[s]], cfg, pl.lays[s])
             for s, h in hs.items()}
    return {s: finish(m[s]) for s, (_, finish) in pre.items()}


def _choose(pl: _Placed, pre: dict, lps_of: dict, g: int, i: int) -> None:
    """Record group ``g``'s block's top-k choices at layer ``i`` in the
    whole batch's dispatch (from its first running sub-group's MLP input
    on its primary device)."""
    s = next(iter(pre))
    lay = pl.lays[s]
    d = lay.primary
    pl.dispatch.choose(i, pl.block_of[g], pre[s][0][d],
                       lps_of[s][lay.first[d]]["mlp"]["router"])


def _expert_mlp(pl: _Placed, g: int, i: int, hs: dict, lps_of: dict,
                cfg: ModelConfig) -> dict:
    """Layer ``i``'s MoE over group ``g``'s expert and tensor shards
    (``parallel/expert.py::placed_moe_mlp``): the MLP input and the
    router of each distinct device of the running sub-groups, and every
    sub-group's shards in mesh order (a sub-group that does not run reads
    its experts alone). Returns each running sub-group's output on its
    devices."""
    from ..parallel.expert import placed_moe_mlp

    h, routers = {}, {}
    for s, hd in hs.items():
        for d, t in pl.lays[s].first.items():
            if d not in h:
                h[d] = hd[d]
                routers[d] = lps_of[s][t]["mlp"]["router"]
    if pl.moe_split:
        shards = []
        for s in pl.subgroups(g):
            mlps = ([lp["mlp"] for lp in lps_of[s]] if s in lps_of
                    else pl.layer(s, i, "mlp"))
            shards += list(zip(pl.lays[s].devices, mlps))
        n_tensor = pl.tp
    else:  # whole experts on every shard: the first running one's
        s0 = next(iter(hs))
        shards, n_tensor = [(pl.lays[s0].primary, lps_of[s0][0]["mlp"])], 1
    route = None
    if pl.dispatch is not None:
        k = pl.block_of[g]

        def route(x, router):
            return pl.dispatch.route(i, k, x, router)

    out = placed_moe_mlp(h, routers, shards, cfg, n_tensor=n_tensor,
                         route=route)
    return {s: {d: out[d] for d in pl.lays[s].distinct} for s in hs}


def _head_names(cfg: ModelConfig) -> tuple:
    return ("embed",) if cfg.tie_embeddings else ("lm_head",)


def _head(pl: _Placed, x: dict, cfg: ModelConfig, g: int) -> torch.Tensor:
    """Group ``g``'s final norm and LM head over the residual ``x``."""
    lay = pl.lays[g]
    shards = pl.top(g, ("final_norm",) + _head_names(cfg))
    xn = {d: _norm(x[d], shards[t]["final_norm"], cfg)
          for d, t in lay.first.items()}
    return _tp_logits(shards, xn, cfg, lay)


class _GroupRun:
    """Group ``g`` over the rows it was given, a layer at a time: the
    rope tables, masks and embedding at construction, :meth:`layer` per
    block, :meth:`out` the output on its first device."""

    def __init__(self, pl: _Placed, g: int, cfg: ModelConfig, x_in,
                 positions, attn_mask, offset, new_len, cache, *,
                 first: bool, last: bool, final_norm: bool, remat: bool,
                 use_flash: bool, attn_fn, kv_upto):
        self.pl, self.g, self.cfg, self.cache = pl, g, cfg, cache
        self.last, self.final_norm, self.remat = last, final_norm, remat
        self.attn_fn, self.kv_upto = attn_fn, kv_upto
        runs = self.runs = pl.runners(g)
        rope, bias, write_at = self.rope, self.bias, self.write_at = \
            {}, {}, {}
        for d in dict.fromkeys(d for s in runs for d in pl.lays[s].distinct):
            pos = to_device(positions, d)
            rope[d] = (rope_tables(pos, _rope_dim(cfg), cfg.rope_theta)
                       if cfg.pos == "rope" else (None, None))
            write_at[d] = to_device(offset, d)
            if use_flash:
                bias[d] = None
                continue
            if cache is not None:
                kv_idx = torch.arange(cache.max_len, device=d)[None, :]
                valid_kv = kv_idx < to_device(new_len, d)[:, None]
            else:
                valid_kv = to_device(attn_mask, d)
            bias[d] = _mask_bias(pos, valid_kv.shape[-1], valid_kv,
                                 cfg.sliding_window)
        if first:
            self.x = {s: _embed(pl, x_in, cfg, positions, s) for s in runs}
        else:
            self.x = {s: {d: to_device(x_in, d).to(cfg.dtype)
                          for d in pl.lays[s].distinct} for s in runs}

    def _args(self, i: int) -> tuple:
        return (self.pl, self.x, self.cfg, self.g, self.rope, self.bias,
                self.cache, self.write_at, self.attn_fn, self.kv_upto, i)

    def layer(self, i: int) -> None:
        args = self._args(i)
        self.x = (checkpoint(_block, *args, use_reentrant=False)
                  if self.remat else _block(*args))

    def pre(self, i: int) -> tuple:
        """Layer ``i`` up to the MLP (a lockstep run's first half)."""
        return _block_pre(*self._args(i))

    def post(self, i: int, pre: tuple) -> None:
        self.x = _block_post(self.pl, *pre, self.cfg, self.g, i)

    def out(self):
        pl, x, cfg, s0 = self.pl, self.x, self.cfg, self.runs[0]
        if self.last:
            return (checkpoint(_head, pl, x[s0], cfg, s0,
                               use_reentrant=False)
                    if self.remat else _head(pl, x[s0], cfg, s0))
        if self.final_norm:
            fn = pl.top(s0, ("final_norm",))[0]["final_norm"]
            return _norm(x[s0][pl.lays[s0].primary], fn, cfg)
        return x[s0][pl.lays[s0].primary]


def _run_group(pl: _Placed, g: int, cfg: ModelConfig, *args, **kw):
    """Group ``g`` over the rows it was given: the output on its first
    device."""
    run = _GroupRun(pl, g, cfg, *args, **kw)
    for i in range(pl.n_layers):
        run.layer(i)
    return run.out()


def _lockstep(pl: _Placed, runs: dict) -> dict:
    """The row blocks' runs (``{group: _GroupRun}``) a layer at a time:
    each block to its MLP, the whole batch's slots settled from every
    block's choices (unless settled already), then each block's MLP.
    Returns each group's output."""
    for i in range(pl.n_layers):
        pres = {g: r.pre(i) for g, r in runs.items()}
        if not pl.dispatch.settled(i):
            for g, pre in pres.items():
                _choose(pl, *pre, g, i)
            pl.dispatch.settle(i)
        for g, r in runs.items():
            r.post(i, pres[g])
    return {g: r.out() for g, r in runs.items()}


def _sparse_blocks(cfg: ModelConfig, blocks: int) -> bool:
    """Whether a forward over ``blocks`` row blocks takes the whole
    batch's sparse dispatch."""
    return bool(cfg.moe and cfg.moe_dispatch == "sparse" and blocks > 1)


def stage(
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
    flash_prefill: bool = False,
    final_norm: bool = False,
    remat: bool = False,
    group: int | None = None,
    take=None,
    dispatch: tuple | None = None,
):
    """``models/transformer.py::_stage_impl`` over a placed tree (see the
    module docstring): ``(out, new_cache)``, ``out`` the logits when
    ``last``, else the hidden states (final-normed when ``final_norm``),
    whole on the mesh's first device. ``remat`` checkpoints each block
    with its gathers. ``group`` runs that (data × fsdp) group alone over
    every given row, without a cache, and returns its output on the
    group's first device (the train step's per-group backward); ``take``
    reads the pieces (:class:`_Placed`). A sparse MoE forward over
    several row blocks dispatches over the whole batch
    (``parallel/expert.py::WholeBatchDispatch``): the blocks run in
    lockstep, a layer at a time; a single group's run takes ``dispatch``,
    ``(the settled dispatch of :func:`dispatch_plan`, its block)``."""
    pl = _Placed(params, cfg, take)
    x_in = tokens if first else hidden
    if x_in is None:
        raise ValueError("first stage requires tokens" if first
                         else "non-first stage requires hidden")
    B, T = x_in.shape[:2]
    dev0 = (pl.primary if group is None
            else pl.lays[pl.subgroups(group)[0]].primary)
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev0)
    length_in = None
    if cache is not None:
        if group is not None:
            raise ValueError("a single group's run takes no cache")
        length_in = cache.length
        offset = (length_in.full(dev0) if isinstance(length_in, Sharded)
                  else to_device(length_in, dev0))
    else:
        offset = torch.zeros((B,), dtype=torch.int32, device=dev0)
    attn_mask = to_device(attn_mask, dev0)
    if positions is None:
        positions = offset.long()[:, None] + torch.arange(
            T, device=dev0)[None]
    positions = to_device(positions, dev0)

    attn_fn, kv_upto = None, None
    use_flash = flash_gate(cfg, T, cache is not None, flash_prefill)
    if use_flash:
        from ..ops.attention import flash_attention

        win = cfg.sliding_window

        def attn_fn(q, k_all, v_all, _bias, scale):
            return flash_attention(q.contiguous(), k_all, v_all,
                                   scale=scale, window=win)

        kv_upto = T
    new_len = offset + attn_mask.sum(-1).to(torch.int32)
    kw = dict(first=first, last=last, final_norm=final_norm, remat=remat,
              use_flash=use_flash, attn_fn=attn_fn, kv_upto=kv_upto)

    if group is not None:
        if dispatch is not None:
            pl.dispatch, pl.block_of = dispatch[0], {group: dispatch[1]}
        out = _run_group(pl, group, cfg, x_in, positions, attn_mask, offset,
                         new_len, None, **kw)
        return out, None
    blocks = _row_blocks(pl, cache, B)
    if cache is not None:
        _check_cache(cache, pl, blocks)
    b = B // blocks
    per_block = pl.n_groups // blocks  # groups sharing a block
    runs: dict = {}
    seen: set = set()
    for g in range(pl.n_groups):
        k = g // per_block
        # a group whose block another group on the same devices ran (or,
        # without a cache to keep a copy of, any group) repeats its work
        key = (k, tuple(d for s in pl.subgroups(g)
                        for d in pl.lays[s].devices)
               if cache is not None else ())
        if key in seen:
            continue
        seen.add(key)
        runs[g] = k
    if _sparse_blocks(cfg, blocks):
        from ..parallel.expert import WholeBatchDispatch

        pl.dispatch, pl.block_of = WholeBatchDispatch(cfg, T,
                                                      [b] * blocks), runs
    outs: dict = {}

    def group_run(g):
        rows = slice(runs[g] * b, (runs[g] + 1) * b)
        return _GroupRun(pl, g, cfg, x_in[rows], positions[rows],
                         attn_mask[rows], offset[rows], new_len[rows], cache,
                         **kw)

    if pl.dispatch is not None:
        firsts = {}
        for g, k in runs.items():
            firsts.setdefault(k, g)
        # blocks in lockstep: a repeated block runs after the first, on
        # the settled slots
        got = _lockstep(pl, {g: group_run(g) for g in firsts.values()})
        outs = {runs[g]: o for g, o in got.items()}
        for g in runs:
            if g not in firsts.values():
                _lockstep(pl, {g: group_run(g)})
    else:
        for g, k in runs.items():
            run = group_run(g)
            for i in range(pl.n_layers):
                run.layer(i)
            outs.setdefault(k, run.out())
    out = (torch.cat([to_device(outs[k], dev0) for k in range(blocks)],
                     dim=0) if blocks > 1 else to_device(outs[0], dev0))
    new_cache = cache
    if cache is not None and pl.n_layers:
        if isinstance(length_in, Sharded):
            from ..parallel.mesh import put

            length = put(length_in.mesh, new_len, length_in.spec)
        else:
            length = to_device(new_len, length_in.device)
        new_cache = KVCache(k=cache.k, v=cache.v, length=length,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)
    return out, new_cache


def logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head of a placed tree over already final-normed ``x``
    (whole), on the mesh's first device."""
    pl = _Placed(_outside_layers(params), cfg)
    lay = pl.lays[0]
    shards = pl.top(0, _head_names(cfg))
    return _tp_logits(shards, {d: to_device(x, d) for d in lay.distinct},
                      cfg, lay)


def head(params: dict, hidden: torch.Tensor, cfg: ModelConfig, *,
         group: int = 0, take=None) -> torch.Tensor:
    """``head_forward`` over a placed tree: final norm and LM head, by
    ``group`` (default the first) on its first device."""
    pl = _Placed(_outside_layers(params), cfg, take)
    s = pl.subgroups(group)[0]
    return _head(pl, {d: to_device(hidden, d).to(cfg.dtype)
                      for d in pl.lays[s].distinct}, cfg, s)


def dispatch_plan(params: dict, cfg: ModelConfig, blocks: list, *,
                  tokens: torch.Tensor | None = None,
                  hidden: torch.Tensor | None = None,
                  attn_mask: torch.Tensor | None = None, first: bool):
    """The whole batch's sparse dispatch of a forward whose row blocks run
    apart: ``blocks`` is ``[(group, rows), …]`` in row order, each
    group's block of the batch (``tokens``/``hidden``). The blocks run in
    lockstep without gradients, and every MoE layer's slots settle;
    returns the :class:`~..parallel.expert.WholeBatchDispatch` (block
    ``k`` is ``blocks[k]``), or None when the forward needs none."""
    from ..parallel.expert import WholeBatchDispatch

    if not _sparse_blocks(cfg, len(blocks)):
        return None
    x_in = tokens if first else hidden
    T = x_in.shape[1]
    pl = _Placed(params, cfg)
    pl.dispatch = WholeBatchDispatch(
        cfg, T, [len(range(*r.indices(x_in.shape[0]))) for _, r in blocks])
    pl.block_of = {g: k for k, (g, _) in enumerate(blocks)}
    runs = {}
    with torch.no_grad():
        for g, rows in blocks:
            dev = pl.lays[pl.subgroups(g)[0]].primary
            n = x_in[rows].shape[0]
            mask = (torch.ones((n, T), dtype=torch.bool, device=dev)
                    if attn_mask is None else to_device(attn_mask[rows], dev))
            zero = torch.zeros((n,), dtype=torch.int32, device=dev)
            pos = torch.arange(T, device=dev)[None].expand(n, T)
            runs[g] = _GroupRun(
                pl, g, cfg, x_in[rows], pos, mask, zero,
                mask.sum(-1).to(torch.int32), None, first=first, last=False,
                final_norm=False, remat=False, use_flash=False, attn_fn=None,
                kv_upto=None)
        _lockstep(pl, runs)
    return pl.dispatch


def _outside_layers(params: dict) -> dict:
    """The tree without its layers: all the head reads (a tree whose
    layers split over ``stage`` runs its head here too)."""
    return {k: v for k, v in params.items() if k != "layers"}


def n_groups(params: dict) -> int:
    """How many (data × fsdp) groups a placed tree's mesh has."""
    sizes = tree_mesh(params).shape
    return sizes.get("data", 1) * sizes.get("fsdp", 1)


def whole(params: dict, device=None) -> dict:
    """A placed tree joined whole (quantized leaves too) on ``device``:
    what a checkpoint or a PARAMS_REQ writes, joined on the host."""
    def join(node):
        if isinstance(node, dict):
            return {k: join(v) for k, v in node.items()}
        if isinstance(node, QTensor) and isinstance(node.q, Sharded):
            return QTensor(q=node.q.full(device), scale=node.scale.full(
                device))
        return full_tree(node, device)

    return join(params)


__all__ = ["dispatch_plan", "head", "head_axis", "logits", "n_groups",
           "stage", "whole"]
