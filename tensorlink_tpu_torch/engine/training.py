"""Training: the causal-LM loss, the optimizer factory and the train step
(port of ``tensorlink_tpu/engine/training.py``).

One step is forward, backward (autograd over :func:`~tensorlink_tpu_torch.
models.transformer.forward`, each block checkpointed under ``remat``) and
the optimizer update of ``engine/optimizers.py`` — optax's formulas, so a
step here and the JAX package's compiled step on the same tree and batch
give the same loss, gradients and parameters within float rounding.

``n_micro > 1`` splits the batch and accumulates gradients in sum form
(each micro's backward is seeded with its token count) in a float32
carry, then divides once by the total token count: the n_micro = 1 step's
token-mean gradient even when loss masks fill the micros unevenly.

``make_train_step(zero1=True, mesh=, dp_axis=)`` is the ZeRO-1 step:
each replica of the ``dp_axis`` accumulates its contiguous block of the
micro-batches with the same helper, the partial sums reduce in a fixed
order (replica 0 first), the global-norm clip runs on the whole
gradient, and the inner elementwise update runs on each replica's 1/dp
slice against optimizer state placed 1/dp per replica
(:func:`optimizer_state_specs`, ``parallel/mesh.py::Sharded``). With
``n_micro == dp`` it is bitwise the unsharded ``n_micro`` step.
``tp_axis`` composes it with the serving tensor parallelism: params
enter and leave as their ``tp_partition_specs`` shards, are joined whole
for the forward and backward, and the update slices over the flattened
``dp·tp`` grid (1/(dp·tp) state per device). ``donate`` is accepted and
ignored: the step returns new tensors either way.

``make_train_step(mesh=)`` without ``zero1`` is the step over a placed
tree, the GSPMD step of JAX written out: params placed by
``partition_specs(tensor_axis=, expert_axis=, fsdp_axis=)`` stay placed,
an expert leaf's gradient on its own expert shards. Each (data ×
fsdp) group runs its block of every micro-batch's rows through
``models/sharded.py`` (each layer's weights gathered from their fsdp
pieces inside the checkpointed block) and differentiates its own
token-sum objective against leaves of its own (:class:`_Pieces`); the
gradients then reduce explicitly, never through autograd's accumulation
into a shared leaf: each piece's gradient is the float32 sum of every
(micro, group) run's gradient of that slice, micro 0 and group 0 first
(:class:`GradFold`, a reduce-scatter in fixed order). The global-norm
clip sums each piece's squares in mesh order and the elementwise update
runs on each device's piece against optimizer state placed by the same
specs (:func:`sharded_update`), so no device ever holds the whole
params, gradients or optimizer state. On a mesh with a ``stage`` axis
(layers placed by ``Split(0, "stage")``) each micro-batch runs once
through the in-mesh GPipe, on a ``seq`` axis through the ring, folded
the same way (:func:`placed_grads`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple

import torch

from ..models.base import ModelConfig
from ..models.transformer import forward
from ..parallel import mesh as _mesh
from ..parallel.mesh import REPLICATED, Split
from . import optimizers as optim


def causal_lm_loss(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]
    loss_mask: torch.Tensor | None = None,  # [B, T] — True where next-token counts
    remat: bool = True,
):
    """Next-token cross-entropy in float32. Returns ``(loss, aux)``."""
    logits, _ = forward(params, tokens, cfg, remat=remat)
    nll_sum, n = _nll_sum(logits, tokens, loss_mask)
    loss = nll_sum / n
    return loss, {"loss": loss, "n_tokens": n}


def _nll_sum(logits, tokens, loss_mask):
    """The next-token cross-entropy's float32 sum and its token count
    (at least 1)."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    if loss_mask is not None:
        mask = loss_mask[:, 1:].bool()
    else:
        mask = torch.ones_like(targets, dtype=torch.bool)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), torch.clamp(mask.sum(), min=1)


class ChainedOptimizer(NamedTuple):
    """A :func:`make_optimizer` result: ``init``/``update`` are the full
    chain's, and the structure stays visible — ``grad_clip`` and ``inner``
    (the stages after the clip)."""

    init: Callable
    update: Callable
    grad_clip: float | None
    inner: optim.GradientTransformation
    name: str


def make_optimizer(
    name: str = "adamw",
    lr: float | Callable = 1e-4,
    *,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float | None = 1.0,
    **kw,
) -> ChainedOptimizer:
    """adamw/adam, sgd or adafactor behind ``clip_by_global_norm`` — the
    JAX package's optax chain."""
    if name in ("adamw", "adam"):
        opt = optim.adamw(lr, b1=b1, b2=b2, weight_decay=weight_decay, **kw)
    elif name == "sgd":
        opt = optim.sgd(lr, **kw)
    elif name == "adafactor":
        opt = optim.adafactor(lr, **kw)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    inner = opt
    if grad_clip:
        opt = optim.chain(optim.clip_by_global_norm(grad_clip), opt)
    return ChainedOptimizer(
        init=opt.init, update=opt.update,
        grad_clip=float(grad_clip) if grad_clip else None,
        inner=inner, name=str(name),
    )


@dataclass
class TrainStep:
    """A train step and its optimizer; ``mode="zero1"`` and
    ``mode="placed"`` carry the mesh its optimizer state is placed on."""

    step_fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    optimizer: Any
    mode: str = "unsharded"  # "unsharded" | "zero1" | "placed"
    mesh: Any = None  # the mesh the optimizer state is placed on
    dp_axis: str = "data"
    tp_axis: str | None = None  # zero1 x tp: the mesh's tensor axis

    def init_state(self, params):
        """The optimizer's state; for ZeRO-1 placed 1/dp per replica (over
        the flattened ``dp·tp`` grid with ``tp_axis``): each leaf whose
        leading dimension divides the grid is split along it; for a placed
        tree placed by its params' specs, made piece by piece."""
        if self.mode == "placed":
            return placed_state(self.optimizer, params, _specs_of(params))
        if self.mode != "zero1":
            return self.optimizer.init(params)
        whole = _mesh.full_tree(params)
        axes, size = _zero1_grid(self.mesh, self.dp_axis, self.tp_axis)
        sspecs = optimizer_state_specs(
            self.optimizer, whole, optim.tree_map(lambda _: REPLICATED,
                                                  whole),
            dp_axis=axes, dp_size=size)
        return _mesh.put(self.mesh, self.optimizer.init(whole), sspecs)

    def n_programs(self) -> int:
        """The JAX step's compiled-program count; eager PyTorch compiles
        nothing, so -1 (the JAX answer for a step without a cache)."""
        return -1


def _trainable(params: dict) -> tuple[dict, list]:
    """A copy of the tree whose leaves require grad (the caller's tensors
    are left alone), and its leaves in :func:`optimizers.tree_leaves`
    order."""
    tree = optim.tree_map(lambda p: p.detach().requires_grad_(True), params)
    return tree, optim.tree_leaves(tree)


def _grads_like(params: dict, leaves: list, grads) -> dict:
    return optim.tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)
    ])


def _accum_micro_grads(sum_grads, params, toks, lm):
    """Gradient accumulation over the leading micro axis of ``toks``/``lm``.
    ``sum_grads`` returns sum-form gradients, so the carry is one add per
    micro, in float32 whatever the params' dtype. Returns
    ``(grad_sums_fp32, nll_sum, tok_sum)``."""
    dev = toks.device
    acc = optim.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
    nll_acc = torch.zeros((), dtype=torch.float32, device=dev)
    tok_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for m in range(toks.shape[0]):
        nll_sum, n_tok, grads = sum_grads(
            params, toks[m], None if lm is None else lm[m])
        acc = optim.tree_map(lambda a, g: a + g.float(), acc, grads)
        nll_acc = nll_acc + nll_sum
        tok_acc = tok_acc + n_tok
    return acc, nll_acc, tok_acc


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    *,
    n_micro: int = 1,
    remat: bool = True,
    loss_fn: Callable | None = None,
    donate: bool = True,
    zero1: bool = False,
    mesh: Any = None,
    dp_axis: str = "data",
    tp_axis: str | None = None,
) -> TrainStep:
    """The train step: ``step_fn(params, opt_state, batch)`` with ``batch``
    a dict of ``"tokens"`` ``[B, T]`` and an optional ``"loss_mask"``,
    returning ``(params, opt_state, {"loss", "grad_norm"})`` — new
    tensors, the metrics as 0-d tensors on the params' device. With
    ``mesh`` and no ``zero1`` the params are a tree placed on ``mesh``
    and stay placed (the module docstring)."""
    if mesh is not None and not zero1:
        if tp_axis is not None:
            raise ValueError("tp_axis requires zero1=True (the sharded step)")
        if loss_fn is not None:
            raise ValueError("the step over a placed tree takes the "
                             "causal-LM loss")
        return _make_placed_step(cfg, optimizer, mesh=mesh,
                                 n_micro=n_micro, remat=remat)
    loss_fn = loss_fn or causal_lm_loss

    def compute_grads(params, tokens, loss_mask):
        tree, leaves = _trainable(params)
        with torch.enable_grad():
            loss, aux = loss_fn(tree, cfg, tokens, loss_mask, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), aux, _grads_like(params, leaves, grads)

    def sum_grads(params, tokens, loss_mask):
        # the token-sum objective: the backward seeded with the micro's
        # token count gives sum-form grads, so the carry is a plain add
        tree, leaves = _trainable(params)
        with torch.enable_grad():
            loss, aux = loss_fn(tree, cfg, tokens, loss_mask, remat=remat)
            n_tok = aux["n_tokens"].float()
            objective = loss * n_tok
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
        return (objective.detach(), n_tok.detach(),
                _grads_like(params, leaves, grads))

    if zero1:
        tp_pspecs = None
        if tp_axis is not None:
            from ..models.transformer import tp_partition_specs, tp_shardable

            if mesh is None:
                raise ValueError("tp_axis requires a mesh")
            if tp_axis not in dict(mesh.shape):
                raise ValueError(
                    f"mesh has no {tp_axis!r} axis: {dict(mesh.shape)}")
            reason = tp_shardable(cfg, int(mesh.shape[tp_axis]))
            if reason is not None:
                raise ValueError(f"tp_axis={tp_axis!r}: {reason}")
            tp_pspecs = tp_partition_specs(cfg, axis=tp_axis)
        return _make_zero1_step(
            optimizer, sum_grads, mesh=mesh, dp_axis=dp_axis,
            n_micro=n_micro, tp_axis=tp_axis, tp_pspecs=tp_pspecs)
    if tp_axis is not None:
        raise ValueError("tp_axis requires zero1=True (the sharded step)")

    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        loss_mask = batch.get("loss_mask")
        if n_micro > 1:
            B = tokens.shape[0]
            if B % n_micro != 0:
                raise ValueError(
                    f"batch {B} not divisible by n_micro={n_micro}")
            mb = B // n_micro
            toks = tokens[: mb * n_micro].reshape(n_micro, mb, -1)
            lm = (loss_mask[: mb * n_micro].reshape(n_micro, mb, -1)
                  if loss_mask is not None else None)
            grads, nll_sum, tok_sum = _accum_micro_grads(
                sum_grads, params, toks, lm)
            tok_sum = torch.clamp(tok_sum, min=1.0)
            # the optimizer takes grads in the params' dtype, as n_micro=1
            grads = optim.tree_map(lambda g, p: (g / tok_sum).to(p.dtype),
                                   grads, params)
            loss = nll_sum / tok_sum
        else:
            loss, _aux, grads = compute_grads(params, tokens, loss_mask)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
            gnorm = optim.global_norm(grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(step_fn=step, optimizer=optimizer)


def _dp_shardable(shape, dp: int) -> bool:
    """THE zero1 sharding predicate: a leaf whose leading dimension the
    grid divides is split along it; any other stays whole per replica."""
    return bool(shape) and shape[0] >= dp and shape[0] % dp == 0


def _zero1_grid(mesh, dp_axis: str, tp_axis: str | None):
    """The axes the update slices over and their size: ``dp_axis``, or
    the flattened ``(dp_axis, tp_axis)`` grid."""
    dp = int(mesh.shape[dp_axis])
    if tp_axis:
        return (dp_axis, tp_axis), dp * int(mesh.shape[tp_axis])
    return dp_axis, dp


def _tmap(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and tuples (an optimizer
    state); None stays None."""
    if isinstance(tree, dict):
        return {k: _tmap(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tmap(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _fold(acc, x: torch.Tensor, device) -> torch.Tensor:
    """THE fixed-order gradient sum: ``x`` added onto the running sum
    ``acc`` (None before the first) on ``device`` — one step of
    ``((x0 + x1) + x2) + …``, the first term first, whatever the count
    (ZeRO-1's cross-replica sum, and each piece's reduce-scatter over the
    groups of a placed step)."""
    x = _mesh.to_device(x, device)
    return x if acc is None else acc + x


def _specs_of(params: dict) -> dict:
    return optim.tree_map(lambda p: p.spec, params)


def _piece_of(x, sp: Split, mesh, j: int):
    """Device ``j``'s piece under ``sp`` of ``x``: a placed leaf's own
    piece (cut finer where ``sp`` refines its layout), or a cut of a whole
    tensor moved there."""
    if isinstance(x, _mesh.Sharded):
        return _mesh.reslice(x, sp, j)
    return _mesh.to_device(_mesh.piece(x, sp, mesh, j), mesh.flat()[j])


def sharded_update(optimizer, grads: dict, state, params: dict,
                   slice_specs: dict, mesh):
    """The optimizer step over a state placed on ``mesh``: the chain's
    global-norm clip on the whole gradient (a shard's norm is not the
    global norm: a placed gradient's norm sums each piece's squares in
    mesh order), then its inner stages on each device's piece of the
    gradient and params — its piece by ``slice_specs``, the spec its
    state twins are placed by — against that device's state. Elementwise
    stages give each piece the whole update's bits. A piece that an
    earlier device of the mesh holds on the same device (a replicated
    leaf of shards sharing a card) is updated once, there. ``grads``/
    ``params`` are whole trees, or trees placed on ``mesh``
    (``slice_specs`` their specs, or finer ones: ZeRO-1 over ``data``);
    returns ``(new_params, new_state)``, the params whole on the params'
    device or placed as they came."""
    grad_clip = getattr(optimizer, "grad_clip", None)
    inner = getattr(optimizer, "inner", optimizer)
    if grad_clip is not None:
        clip = optim.clip_by_global_norm(grad_clip)
        grads, _ = clip.update(grads, (), params)
        clip_state, inner_state = state[0], state[1]
    else:
        clip_state, inner_state = None, state
    flat = mesh.flat()

    def owners(spec: Split) -> list:
        """Each device's owner under ``spec``: the first device of the
        mesh on the same device holding the same piece."""
        seen: dict = {}
        return [seen.setdefault((flat[j], k), j)
                for j, k in enumerate(_mesh._keys(mesh, spec))]

    pdef = _structure(params)

    def prune(node, specs, j):
        """``node`` (structured like the params) without the leaves whose
        piece device ``j`` does not own; None when nothing is left."""
        if isinstance(node, dict):
            out = {k: prune(v, specs[k], j) for k, v in node.items()}
            out = {k: v for k, v in out.items() if v is not None}
            return out or None
        return node if owners(specs)[j] == j else None

    def prune_state(node, j):
        if isinstance(node, dict) and _structure(node) == pdef:
            return prune(node, slice_specs, j) or {}
        if isinstance(node, dict):
            return {k: prune_state(v, j) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(prune_state(v, j) for v in node)
        return node

    new_p, new_s = {}, {}
    for j in range(mesh.size):
        def cut(x, sp, j=j):
            return _piece_of(x, sp, mesh, j)

        p_j = prune(optim.tree_map(cut, params, slice_specs), slice_specs, j)
        if p_j is None:
            continue
        g_j = prune(optim.tree_map(cut, grads, slice_specs), slice_specs, j)
        s_j = prune_state(_tmap(lambda t, j=j: t.shards[j], inner_state), j)
        u_j, ns_j = inner.update(g_j, s_j, p_j)
        new_p[j] = optim.apply_updates(p_j, u_j)
        new_s[j] = ns_j

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def join_param(p, sp, path=()):
        if isinstance(p, dict):
            return {k: join_param(v, sp[k], path + (k,))
                    for k, v in p.items()}
        x = _mesh.from_pieces([at(new_p[o], path) for o in owners(sp)], sp,
                              p.shape, mesh)
        if isinstance(p, _mesh.Sharded):
            return _mesh.respec(x, p.spec)
        return x.full(p.device)

    def join_state(old, path=()):
        if isinstance(old, dict):
            return {k: join_state(v, path + (k,)) for k, v in old.items()}
        if isinstance(old, tuple):
            return tuple(join_state(v, path + (i,))
                         for i, v in enumerate(old))
        if old is None:
            return None
        return _mesh.from_pieces([at(new_s[o], path)
                                  for o in owners(old.spec)], old.spec,
                                 old.shape, mesh)

    params = join_param(params, slice_specs)
    inner_state = join_state(inner_state)
    state = (clip_state, inner_state) if grad_clip is not None \
        else inner_state
    return params, state


def _structure(t):
    """A tree's dict structure, its leaves (None kept) as markers."""
    if isinstance(t, dict):
        return {k: _structure(v) for k, v in t.items()}
    return None if t is None else "leaf"


def placed_state(optimizer, params: dict, slice_specs: dict, *,
                 dp_axis: str | None = None, dp_size: int = 0):
    """The optimizer state of a placed tree, made piece by piece (the
    whole is never built): each device's ``optimizer.init`` over its
    pieces of the params by ``slice_specs``, placed by
    :func:`optimizer_state_specs` over the params' own specs
    (``dp_axis``/``dp_size``: its ZeRO-1 extension, which
    ``slice_specs`` must give too). An update that is not elementwise
    (adafactor's factored moments) refuses a tree split over any axis."""
    mesh = _mesh.tree_mesh(params)
    if getattr(optimizer, "name", "") == "adafactor" and any(
            p.spec != REPLICATED for p in optim.tree_leaves(params)):
        raise ValueError("a placed tree needs an elementwise optimizer "
                         "update; adafactor's factored second moments are "
                         "not — use adamw/sgd")
    sspecs = optimizer_state_specs(optimizer, params, _specs_of(params),
                                   dp_axis=dp_axis, dp_size=dp_size)
    meta = optimizer.init(optim.tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
        params))
    per = [optimizer.init(optim.tree_map(
        lambda p, sp, j=j: _piece_of(p, sp, mesh, j), params, slice_specs))
        for j in range(mesh.size)]
    return _tmap(lambda m, sp, *pieces: _mesh.from_pieces(
        list(pieces), sp, m.shape, mesh), meta, sspecs, *per)


class _Pieces:
    """A ``take`` for ``models/sharded.py``: each piece a group's forward
    reads (layer ``layer`` of a stacked one) becomes a leaf of its own,
    so the group's backward gives that slice's gradient and nothing
    accumulates across groups inside autograd."""

    def __init__(self):
        self.made: dict = {}

    def __call__(self, leaf, j, layer):
        t = leaf.shards[j] if isinstance(leaf, _mesh.Sharded) else leaf
        key = (id(t), layer)
        if key not in self.made:
            v = t if layer is None else t[layer]
            self.made[key] = (leaf, j, layer,
                              v.detach().requires_grad_(True))
        return self.made[key][3]

    def leaves(self) -> list:
        return [m[3] for m in self.made.values()]


class GradFold:
    """A placed tree's gradient, reduced in a fixed order: one float32
    sum per piece of each leaf (on the first device holding it), to which
    every group run adds its gradients of that piece in run order
    (:func:`_fold`'s arithmetic, accumulated in place) — the
    reduce-scatter of a placed step, with the data replicas' runs summed
    in too. Each run's backward runs on the calling thread, so every sum
    inside it has one order too, over distinct cards as on one."""

    def __init__(self, params: dict):
        self.params = params
        self.sums: dict = {}  # (id(leaf), key) -> float32 piece sum

    def run(self, fn, extra: list = ()):
        """One group run: ``fn(take)`` returns ``(outputs, cotangents)``
        (``cotangents`` None for a scalar objective); its gradients are
        folded in and those of ``extra`` (inputs that require grad)
        returned."""
        take = _Pieces()
        with torch.enable_grad():
            outs, cots = fn(take)
            leaves = take.leaves()
            # the backward on this thread: autograd's per-device threads
            # would sum an activation's gradient copies in arrival order,
            # and two of them can recompute one checkpointed block at once
            with torch.autograd.set_multithreading_enabled(False):
                grads = torch.autograd.grad(outs, leaves + list(extra),
                                            cots, allow_unused=True)
        with torch.no_grad():
            for (leaf, j, layer, _), g in zip(take.made.values(),
                                              grads[:len(leaves)]):
                if g is None:
                    continue
                key = leaf.keys()[j]
                acc = self.sums.get((id(leaf), key))
                if acc is None:
                    src = leaf.shards[leaf.first_of_keys()[key]]
                    acc = torch.zeros(src.shape, dtype=torch.float32,
                                      device=src.device)
                    self.sums[(id(leaf), key)] = acc
                dst = acc if layer is None else acc[layer]
                dst.add_(_mesh.to_device(g, dst.device).float())
        return grads[len(leaves):]

    def result(self, scale=None) -> dict:
        """The gradient placed like the params, in their dtypes: each
        piece's sum (zeros where no run read it), times ``scale`` (a
        scalar tensor) when given."""
        def leaf_grad(p):
            def make(key, dev):
                acc = self.sums.get((id(p), key))
                if acc is None:
                    shape = p.shards[p.first_of_keys()[key]].shape
                    return torch.zeros(shape, dtype=p.dtype, device=dev)
                acc = _mesh.to_device(acc, dev)
                if scale is not None:
                    acc = acc * _mesh.to_device(scale, dev)
                return acc.to(p.dtype)

            return _mesh.placed(p.mesh, p.spec, tuple(p.shape), make)

        return optim.tree_map(leaf_grad, self.params)


def _group_rows(B: int, n_micro: int, n_groups: int) -> list:
    """The runs of a placed step in order, ``(micro, group, rows)``: group
    ``g`` holds the contiguous block ``[g·B/G, (g+1)·B/G)`` of the batch's
    rows (floored: a batch the groups do not divide leaves some a row
    fewer, or none) and runs it micro by micro (its block's overlap with
    each micro-batch); every row runs once."""
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    out = []
    for m in range(n_micro):
        for g in range(n_groups):
            lo = max(m * mb, g * B // n_groups)
            hi = min((m + 1) * mb, (g + 1) * B // n_groups)
            if lo < hi:
                out.append((m, g, slice(lo, hi)))
    return out


def placed_grads(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 loss_mask: torch.Tensor | None = None, *, n_micro: int = 1,
                 remat: bool = True) -> tuple:
    """The token-mean gradient of the causal-LM loss over a placed tree,
    placed like it: each (micro, group) run of :func:`_group_rows` through
    ``models/sharded.py::stage(group=)`` — or, on a stage or seq mesh,
    each micro-batch through the in-mesh GPipe (``parallel/pipeline.py``,
    ``pp_n_micro`` micro-batches of its own) or the ring
    (``models/transformer.py::_seq_stage``) — differentiates its
    token-sum objective, the runs fold per piece in order
    (:class:`GradFold`) and the sums divide once by the batch's token
    count. Returns ``(grads, loss)``, the loss on the mesh's first
    device."""
    from ..models import sharded
    from ..models.transformer import _seq_stage
    from ..parallel.pipeline import pipelined_stage_forward, pp_n_micro

    mesh = _mesh.tree_mesh(params)
    dev0 = mesh.flat()[0]
    fold = GradFold(params)
    nll_acc = tok_acc = None
    kind = _in_mesh_axis(mesh)
    if kind is None:
        runs = _group_rows(tokens.shape[0], n_micro,
                           sharded.n_groups(params))
        plans = _dispatch_plans(params, cfg, runs, tokens=tokens, first=True)
    else:  # every row of a micro-batch in one run
        runs, plans = _group_rows(tokens.shape[0], n_micro, 1), {}
    for m, g, rows in runs:
        sums: dict = {}

        def objective(take, m=m, g=g, rows=rows, sums=sums):
            toks = tokens[rows]
            kw = dict(tokens=toks, first=True, last=True, remat=remat,
                      take=take)
            if kind == "stage":
                out, _ = pipelined_stage_forward(
                    params, cfg, mesh, n_micro=pp_n_micro(
                        mesh.shape["stage"], toks.shape[0]), **kw)
            elif kind == "seq":
                out, _ = _seq_stage(params, cfg, mesh, **kw)
            else:
                out, _ = sharded.stage(params, cfg, group=g,
                                       dispatch=plans.get((m, g)), **kw)
            lm = None if loss_mask is None else loss_mask[rows].to(
                out.device)
            nll, n = _nll_sum(out, toks.to(out.device), lm)
            sums.update(nll=nll.detach(), n=n)
            return nll, None

        fold.run(objective)
        nll_acc = _fold(nll_acc, sums["nll"], dev0)
        tok_acc = _fold(tok_acc, sums["n"].float(), dev0)
    tok_sum = torch.clamp(tok_acc, min=1.0)
    with torch.no_grad():
        return fold.result(1.0 / tok_sum), nll_acc / tok_sum


def _dispatch_plans(params: dict, cfg: ModelConfig, runs: list, *,
                    tokens=None, hidden=None, attn_mask=None,
                    first: bool) -> dict:
    """Each (micro, group) run's ``(dispatch, block)`` where a sparse MoE
    micro-batch spans several groups' row blocks: the micro-batch's
    whole-batch slots (``models/sharded.py::dispatch_plan``), as JAX's
    step dispatches each micro-batch's tokens together."""
    from ..models import sharded

    out: dict = {}
    for m in dict.fromkeys(r[0] for r in runs):
        blocks = [(g, rows) for mm, g, rows in runs if mm == m]
        plan = sharded.dispatch_plan(params, cfg, blocks, tokens=tokens,
                                     hidden=hidden, attn_mask=attn_mask,
                                     first=first)
        if plan is not None:
            for k, (g, _) in enumerate(blocks):
                out[(m, g)] = (plan, k)
    return out


def _in_mesh_axis(mesh) -> str | None:
    """The in-mesh program a placed step's forward runs: ``"stage"`` (the
    GPipe) or ``"seq"`` (the ring) for such an axis above 1, else None
    (the placed forward of ``models/sharded.py``)."""
    sizes = mesh.shape
    if sizes.get("stage", 1) > 1:
        return "stage"
    if sizes.get("seq", 1) > 1:
        return "seq"
    return None


def _make_placed_step(cfg, optimizer, *, mesh, n_micro, remat) -> TrainStep:
    """The step over a tree placed on ``mesh`` (the module docstring):
    :func:`placed_grads`, then :func:`sharded_update` on each device's
    pieces."""

    def step(params, opt_state, batch):
        if _mesh.tree_mesh(params) is not mesh:
            raise ValueError("the params are not placed on the step's mesh")
        grads, loss = placed_grads(params, cfg, batch["tokens"],
                                   batch.get("loss_mask"), n_micro=n_micro,
                                   remat=remat)
        with torch.no_grad():
            gnorm = optim.global_norm(grads)
            new_params, new_state = sharded_update(
                optimizer, grads, opt_state, params, _specs_of(params), mesh)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(step_fn=step, optimizer=optimizer, mode="placed",
                     mesh=mesh)


def _make_zero1_step(optimizer, sum_grads, *, mesh, dp_axis, n_micro,
                     tp_axis=None, tp_pspecs=None) -> TrainStep:
    """The ZeRO-1 step (JAX ``_make_zero1_step``), its five stages
    written out over the mesh's replicas:

    0.5 with ``tp_axis``: each leaf joined whole from its serving shards
        (an exact concatenation);
    1. each replica's local micro accumulation, on its first device, over
       its contiguous block of the micro-batches (the shared
       :func:`_accum_micro_grads`);
    2. the fixed-order cross-replica sum, replica 0 first — with one
       micro per replica the unsharded carry's own additions;
    3. the global-norm clip on the whole gradient;
    4. the elementwise inner update on each device's 1/dp (1/(dp·tp))
       slice against its resident state piece;
    5. the re-join (and, with ``tp_axis``, the re-slice into serving
       shards)."""
    if mesh is None:
        raise ValueError("zero1=True requires a mesh with a dp axis")
    if dp_axis not in dict(mesh.shape):
        raise ValueError(f"mesh has no {dp_axis!r} axis: {dict(mesh.shape)}")
    dp = int(mesh.shape[dp_axis])
    if dp < 2:
        raise ValueError(
            f"zero1 needs {dp_axis} > 1 (got {dp}) — the planner picks the "
            "unsharded step for single-replica meshes"
        )
    if n_micro % dp != 0:
        raise ValueError(
            f"zero1 needs n_micro ({n_micro}) divisible by {dp_axis}={dp} "
            "so each replica scans whole micro-batches"
        )
    if getattr(optimizer, "name", "") == "adafactor":
        raise ValueError(
            "zero1 requires a shard-local (elementwise) optimizer update; "
            "adafactor's factored second moments are not — use adamw/sgd"
        )
    axes, world = _zero1_grid(mesh, dp_axis, tp_axis)
    local_micro = n_micro // dp
    flat = mesh.flat()
    # replica d's first device (its tp peers see the same batch block)
    replica_dev = [flat[mesh.axis_index(dp_axis).index(d)]
                   for d in range(dp)]

    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        loss_mask = batch.get("loss_mask")
        B = tokens.shape[0]
        if B % n_micro != 0:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        whole = _mesh.full_tree(params)
        dev0 = optim.tree_leaves(whole)[0].device
        blk = local_micro * mb
        partial = []
        for d in range(dp):
            dev = replica_dev[d]
            p_d = optim.tree_map(lambda p: _mesh.to_device(p, dev), whole)
            toks = tokens[d * blk:(d + 1) * blk].to(dev).reshape(
                local_micro, mb, -1)
            lm = (loss_mask[d * blk:(d + 1) * blk].to(dev).reshape(
                local_micro, mb, -1) if loss_mask is not None else None)
            partial.append(_accum_micro_grads(sum_grads, p_d, toks, lm))

        def ordered(*xs):
            acc = None
            for x in xs:
                acc = _fold(acc, x, dev0)
            return acc

        with torch.no_grad():
            grads = optim.tree_map(ordered, *[g for g, _, _ in partial])
            nll_sum = ordered(*[n for _, n, _ in partial])
            tok_sum = torch.clamp(ordered(*[t for _, _, t in partial]),
                                  min=1.0)
            grads = optim.tree_map(lambda g, p: (g / tok_sum).to(p.dtype),
                                   grads, whole)
            loss = nll_sum / tok_sum
            gnorm = optim.global_norm(grads)
            slice_specs = optim.tree_map(lambda p: dp_extended(
                REPLICATED, tuple(p.shape), axes, world), whole)
            new_params, new_state = sharded_update(
                optimizer, grads, opt_state, whole, slice_specs, mesh)
            if tp_axis is not None:
                new_params = _mesh.put(mesh, new_params, tp_pspecs)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(step_fn=step, optimizer=optimizer, mode="zero1",
                     mesh=mesh, dp_axis=dp_axis, tp_axis=tp_axis)


def dp_extended(spec: Split, shape: tuple, dp_axis, dp_size: int) -> Split:
    """``spec`` with its leading dimension also split over ``dp_axis``
    (a tuple: their flattened grid) when ``dp_size`` divides it and the
    spec leaves it whole; anything else as it is."""
    if not dp_axis or dp_size <= 1 or not _dp_shardable(shape, dp_size):
        return spec
    if 0 in spec.dims():
        return spec  # dim 0 already split — never compose
    if spec.dim is None and spec.fsdp_dim is None \
            and spec.expert_dim is None:
        return Split(0, dp_axis)
    if dp_axis != "data" or spec.data_dim is not None:
        return spec
    return replace(spec, data_dim=0)


def optimizer_state_specs(optimizer, params: dict, param_specs: dict, *,
                          dp_axis: "str | tuple | None" = None,
                          dp_size: int = 0):
    """The spec tree of an optimizer state (JAX ``optimizer_state_specs``):
    a sub-tree that mirrors the param tree (Adam's moments, a momentum
    trace) takes the params' specs; scalars (step counts) replicate.

    ``dp_axis``/``dp_size`` is the ZeRO-1 extension: a state leaf whose
    leading dimension divides ``dp_size`` is also split along it over
    ``dp_axis`` (a tuple: their flattened grid) — unless its spec already
    splits that dimension, which is left as it is. A state leaf outside a
    mirroring sub-tree (a masked moment tree, whose masked-out leaves are
    None; a factored second moment) takes the spec of the one param of its
    shape when there is exactly one, else the dp split when its leading
    dimension divides, else replicates with a warning."""
    from ..core.logging import get_logger

    meta = optim.tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
        params)
    state = optimizer.init(meta)
    pdef = _structure(params)

    def with_dp(spec: Split, shape: tuple) -> Split:
        return dp_extended(spec, shape, dp_axis, dp_size)

    shape_specs: dict[tuple, list] = {}
    for pl, sp in zip(optim.tree_leaves(params),
                      optim.tree_leaves(param_specs)):
        cands = shape_specs.setdefault(tuple(pl.shape), [])
        if sp not in cands:
            cands.append(sp)
    log = get_logger("engine.training")

    def stray(leaf) -> Split:
        shape = tuple(leaf.shape)
        cands = shape_specs.get(shape, [])
        if len(cands) == 1:
            return with_dp(cands[0], shape)
        if dp_axis and dp_size > 1 and _dp_shardable(shape, dp_size):
            return with_dp(REPLICATED, shape)
        if shape and any(d > 1 for d in shape):
            log.warning(
                "optimizer state leaf of shape %s matches no unique param "
                "layout — replicating it (candidates: %s)", shape, cands)
        return REPLICATED

    def walk(node):
        if isinstance(node, dict) and _structure(node) == pdef:
            return optim.tree_map(lambda sp, leaf: with_dp(
                sp, tuple(leaf.shape)), param_specs, node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if node is None:
            return None
        return stray(node)

    return walk(state)


__all__ = [
    "ChainedOptimizer",
    "GradFold",
    "TrainStep",
    "causal_lm_loss",
    "make_optimizer",
    "make_train_step",
    "dp_extended",
    "optimizer_state_specs",
    "placed_grads",
    "placed_state",
    "sharded_update",
]
