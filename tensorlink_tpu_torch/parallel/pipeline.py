"""Pipeline parallelism inside one mesh: the GPipe schedule over a
``stage`` axis (port of ``tensorlink_tpu/parallel/pipeline.py``).

A stage's layer slice is split over the ``stage`` mesh axis: stage
``s`` holds its ``L/n_stage`` layers on its device (a leaf placed by
``Split(0, "stage")``, JAX's ``P("stage", ...)``). The batch splits into
``n_micro`` micro-batches that stream through the stages: at tick ``t``
stage ``s`` runs micro-batch ``t - s``, over ``n_micro + n_stage - 1``
ticks, and an activation moves to the next stage's device with
:func:`~.mesh.to_device`, which is JAX's ``ppermute``. The loop is the
schedule written out, in PyTorch's own idiom: one controller issues
every stage's launches in tick order, so over distinct cards the stages
overlap as the card queues allow. The bubble's dead (stage, tick) pairs
are skipped; JAX computes them and masks them out, so the outputs are the
same. Autograd gives the backward, the reverse sweep over the same
hops.

:func:`pipelined_stage_forward` is the entry point the worker runs a
stage's slice through when its plan's mesh has a ``stage`` axis
(``ml/worker.py``), with ``models.transformer.stage_forward``'s
semantics: the embedding and the head run outside the pipelined region,
on the mesh's first device, from the replicated leaves there.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import Mesh, Sharded, to_device

__all__ = ["gpipe", "pipelined_stage_forward", "pp_n_micro"]


def pp_n_micro(pp_size: int, batch: int) -> int:
    """The in-mesh micro-batch count (the JAX worker's ``_pp_n_micro``):
    two micro-batches a stage where the batch allows (a small bubble),
    else what divides it — sized to the stage axis, whatever the plan's
    gradient-accumulation ``n_micro``."""
    for cand in (2 * pp_size, pp_size, 2, 1):
        if batch % cand == 0:
            return cand
    return 1


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _read(take):
    """The reader of flattened device ``j``'s piece of a leaf: ``take``
    (a train step's, which makes each piece a leaf of its own) or the
    piece itself."""
    if take is not None:
        return lambda leaf, j: take(leaf, j, None)
    return lambda leaf, j: leaf.shards[j] if isinstance(leaf, Sharded) \
        else leaf


def _stage_slices(stacked, mesh: Mesh, axis_name: str, take) -> list:
    """Each stage's local layer slice on its device: its piece of a leaf
    placed over ``axis_name`` along dim 0, or its cut of a whole leaf
    moved there (differentiable into the whole leaf)."""
    members = mesh.axis_members(axis_name)
    n_stage = len(members)
    flat = mesh.flat()
    read = _read(take)
    out = []
    for s, j in enumerate(members):
        def cut(leaf, s=s, j=j):
            if isinstance(leaf, Sharded):
                if leaf.spec.dim != 0 or leaf.grid[0] != n_stage:
                    raise ValueError(f"a layer leaf {leaf.spec} is not "
                                     f"split over {axis_name!r} along its "
                                     f"layers")
                return read(leaf, j)
            n = leaf.shape[0] // n_stage
            return to_device(leaf[s * n:(s + 1) * n], flat[j])
        out.append(_tmap(cut, stacked))
    return out


def gpipe(
    stage_fn: Callable,  # (local_layer_params, x) -> y, applied per stage
    stacked_params,  # tree, leaves with leading layer dim L (L % n_stage == 0)
    micros,  # tree of micro stacks, leaves [n_micro, mb, ...]
    mesh: Mesh,
    *,
    axis_name: str = "stage",
    take=None,
):
    """Run ``micros`` through the layer pipeline: the same tree of
    ``[n_micro, ...]`` outputs as applying every layer in turn, on the
    last stage's device. ``stage_fn`` maps its input tree to an output of
    the same structure and shapes (a passthrough leaf, such as a micro's
    mask, is returned unchanged). ``stacked_params`` leaves are whole
    (each stage takes its cut) or placed over ``axis_name`` along dim 0;
    ``take`` reads a placed leaf's pieces (the train step's reader)."""
    members = mesh.axis_members(axis_name)
    n_stage = len(members)
    flat = mesh.flat()
    n_local = [leaf.shape[0] for leaf in _leaves(stacked_params)]
    if any(n % n_stage for n in n_local):
        raise ValueError(f"{n_local[0]} layers not divisible by stage axis "
                         f"{n_stage}")
    local = _stage_slices(stacked_params, mesh, axis_name, take)
    n_micro = _leaves(micros)[0].shape[0]
    carry: dict = {}  # micro -> the activation the next stage takes
    outs: list = [None] * n_micro
    for t in range(n_micro + n_stage - 1):
        for s in range(n_stage):
            m = t - s  # the micro-batch stage s works on at tick t
            if not 0 <= m < n_micro:
                continue
            dev = flat[members[s]]
            x = (_tmap(lambda leaf, m=m: leaf[m], micros) if s == 0
                 else carry.pop(m))
            y = stage_fn(local[s], _tmap(lambda a, dev=dev: to_device(a, dev),
                                          x))
            if s == n_stage - 1:
                outs[m] = y
            else:
                carry[m] = y
    last = flat[members[-1]]

    def stack(*ys):
        return torch.stack([to_device(y, last) for y in ys], dim=0)

    return _zip_map(stack, outs)


def _zip_map(fn, trees: list):
    """``fn`` over the matching leaves of several trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_map(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(*trees)


def pipelined_stage_forward(
    params: dict,
    cfg,
    mesh: Mesh,
    *,
    tokens: torch.Tensor | None = None,  # int [B, T] (first stage)
    hidden: torch.Tensor | None = None,  # [B, T, D] (later stages)
    attn_mask: torch.Tensor | None = None,  # bool [B, T]
    n_micro: int,
    axis_name: str = "stage",
    first: bool = False,
    last: bool = False,
    remat: bool = False,
    take=None,
):
    """``stage_forward`` with this stage's layer slice itself pipelined
    over ``mesh[axis_name]``: ``(out, None)``, ``out`` the logits when
    ``last`` and else the hidden states, on the mesh's first device.

    The batch splits into ``n_micro`` micro-batches that stream through
    the layer pipeline (:func:`gpipe`); the embedding and the head run
    outside it on the mesh's first device. No KV cache: this is the
    training and whole-sequence path, and serving plans never carry a
    ``stage`` axis (``parallel/planner.py``). ``remat`` checkpoints each
    block (``torch.utils.checkpoint``, as ``stage_forward`` does);
    ``take`` reads a placed tree's pieces (the train step's reader)."""
    from ..models.transformer import (
        _block,
        _embed_tokens,
        _layers,
        _logits,
        _mask_bias,
        _norm,
        _rope_dim,
        rope_tables,
    )

    if first:
        if tokens is None:
            raise ValueError("first stage requires tokens")
        B, T = tokens.shape
    else:
        if hidden is None:
            raise ValueError("non-first stage requires hidden")
        B, T = hidden.shape[:2]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    members = mesh.axis_members(axis_name)
    n_stage = len(members)
    n_local = _leaves(params["layers"])[0].shape[0]
    if n_local % n_stage != 0:
        raise ValueError(
            f"{n_local} layers not divisible by stage axis {n_stage}")
    mb = B // n_micro
    flat = mesh.flat()
    dev0 = flat[0]
    read = _read(take)

    def top(leaf):  # a replicated leaf outside the layers, on dev0
        if isinstance(leaf, Sharded):
            on = [j for j, d in enumerate(flat) if d == dev0]
            return read(leaf, on[0])
        return to_device(leaf, dev0)

    outer = {k: _tmap(top, v) for k, v in params.items() if k != "layers"}
    if first:
        x = _embed_tokens(outer, to_device(tokens, dev0).long(), cfg)
        if cfg.pos == "learned":
            pos = torch.arange(T, device=dev0)[None, :]
            x = x + outer["embed"]["pos"][pos].to(cfg.dtype)
    else:
        x = to_device(hidden, dev0).to(cfg.dtype)

    # no cache: absolute positions are the local ones
    stage_devs = [flat[j] for j in members]
    rope = {}
    for d in dict.fromkeys(stage_devs):
        pos = torch.arange(T, device=d)[None, :]
        rope[d] = (rope_tables(pos, _rope_dim(cfg), cfg.rope_theta)
                   if cfg.pos == "rope" else (None, None))
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=dev0)
    qpos = torch.arange(T, device=dev0)[None, :].expand(B, T)
    bias = _mask_bias(qpos, T, to_device(attn_mask, dev0),
                      cfg.sliding_window)  # [B, 1, 1, T, T]

    def stage_fn(layer_slice, x_in):
        act, b = x_in
        cos, sin = rope[act.device]
        for lp in _layers({"layers": layer_slice}):
            if remat:
                act = checkpoint(_block, act, lp, cfg, cos, sin, b, None,
                                 None, use_reentrant=False)
            else:
                act = _block(act, lp, cfg, cos, sin, b, None, None)
        return act, b

    micros = (x.reshape(n_micro, mb, T, -1),
              bias.reshape(n_micro, mb, *bias.shape[1:]))
    out, _ = gpipe(stage_fn, params["layers"], micros, mesh,
                   axis_name=axis_name, take=take)
    x = to_device(out.reshape(B, T, -1), dev0)
    if last:
        x = _norm(x, outer["final_norm"], cfg)
        return _logits(outer, x, cfg), None
    return x, None
