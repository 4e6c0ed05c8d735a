"""The optax gradient transformations the training path uses, ported to
PyTorch with optax 0.2.6's formulas.

A transformation is a :class:`GradientTransformation` ``(init, update)``
over parameter trees: nested dicts of tensors, as ``init_params`` builds
them. Its state keeps optax's structure with plain tuples in place of
optax's NamedTuples — ``(count, mu, nu)`` for Adam, ``()`` for an
``EmptyState``, ``(trace,)`` for momentum, ``(count, v_row, v_col, v)``
for Adafactor's factored moments, a tuple of the stages' states for a
chain — and every step count is an int32 scalar tensor on the parameters'
device. :func:`tree_leaves` flattens a state the way ``jax.tree.leaves``
flattens the optax one (dict keys in sorted order), so the two line up
leaf for leaf and a TLTS training checkpoint moves between the packages.

``torch.optim`` is deliberately not used: its AdamW decays the weights
before the moment update (optax adds the decay to the Adam update), and
its state layout matches nothing in the JAX package.

Nothing here syncs the host: the clip's trigger and the step counts stay
on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..parallel.mesh import Sharded, map_pieces, to_device

_INT32_MAX = 2**31 - 1


class GradientTransformation(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(updates, state, params=None) -> (updates, state)``."""

    init: Callable
    update: Callable


# -- trees ----------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure); None stays None, as an absent optax leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, tuples and lists in ``jax.tree.leaves``
    order: dict keys sorted, sequences in order, None empty."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves: list):
    """Lay ``leaves`` (in :func:`tree_leaves` order) into the structure of
    ``like``; each new leaf takes its template leaf's device and dtype."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            # leaves come in sorted-key order; the dict keeps its own order
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        if isinstance(node, list):
            return [build(v) for v in node]
        if node is None:
            return None
        leaf = next(it)
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        return t.to(device=node.device, dtype=node.dtype).reshape(node.shape)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _sum_sq(x) -> torch.Tensor:
    """A leaf's sum of squares; a placed leaf's is the sum of its pieces'
    (each piece once, in mesh order) on its first device, with no piece
    joined to another."""
    if not isinstance(x, Sharded):
        return torch.sum(x * x)
    dev = x.shards[0].device
    total = None
    for j in x.first_of_keys().values():
        t = x.shards[j]
        s = to_device(torch.sum(t * t), dev)
        total = s if total is None else total + s
    return total


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum, over the leaves
    in order, of each leaf's sum of squares (over a placed tree, each
    piece's, :func:`_sum_sq`)."""
    total = None
    for x in tree_leaves(tree):
        s = _sum_sq(x)
        total = s if total is None else total + to_device(s, total.device)
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def apply_updates(params, updates):
    """``optax.apply_updates``: ``p + u`` cast back to ``p``'s dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# -- helpers --------------------------------------------------------------
def _device(params):
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """``numerics.safe_increment`` of an int32 count."""
    return torch.where(count < _INT32_MAX, count + 1,
                       torch.full_like(count, _INT32_MAX))


def _bias_correction(moment, decay: float, count: torch.Tensor):
    """``tree_bias_correction``: ``1 - decay**count`` in float32, then the
    division in each moment's own precision."""
    bc = 1 - torch.pow(torch.tensor(decay, dtype=torch.float32,
                                    device=count.device), count.float())
    return tree_map(lambda t: t / bc.to(t.dtype), moment)


def _zeros_like(params, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def _empty(_params=None) -> tuple:
    return ()


# -- transformations ------------------------------------------------------
def identity() -> GradientTransformation:
    return GradientTransformation(_empty, lambda u, s, p=None: (u, s))


def scale(step_size: float) -> GradientTransformation:
    """``optax.scale``: every update times ``step_size``."""

    def update(updates, state, params=None):
        return tree_map(lambda g: step_size * g, updates), state

    return GradientTransformation(_empty, update)


def scale_by_schedule(step_size_fn: Callable) -> GradientTransformation:
    """``optax.scale_by_schedule``: state ``(count,)``; the schedule sees
    the int32 count of updates applied so far."""

    def init(params):
        return (_count(params),)

    def update(updates, state, params=None):
        (count,) = state
        step = step_size_fn(count)

        def one(g):
            return torch.as_tensor(step, device=g.device).to(g.dtype) * g

        return tree_map(one, updates), (_safe_increment(count),)

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate, *,
                           flip_sign: bool = True) -> GradientTransformation:
    if learning_rate is None:
        return identity()
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0, mu_dtype: torch.dtype | None = None,
                  *, nesterov: bool = False) -> GradientTransformation:
    """``optax.scale_by_adam``: state ``(count, mu, nu)``."""

    def init(params):
        return (_count(params), _zeros_like(params, mu_dtype),
                _zeros_like(params))

    def update(updates, state, params=None):
        count, mu, nu = state
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, nu)
        count_inc = _safe_increment(count)
        if nesterov:
            mu_hat = tree_map(
                lambda m, g: b1 * m + (1 - b1) * g,
                _bias_correction(mu, b1, _safe_increment(count_inc)),
                _bias_correction(updates, b1, count_inc),
            )
        else:
            mu_hat = _bias_correction(mu, b1, count_inc)
        nu_hat = _bias_correction(nu, b2, count_inc)
        out = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                       mu_hat, nu_hat)
        if mu_dtype is not None:
            mu = tree_map(lambda t: t.to(mu_dtype), mu)
        return out, (count_inc, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay=0.0, mask=None) -> GradientTransformation:
    """``optax.add_decayed_weights``: ``g + weight_decay * p`` (applied
    even at 0.0, as optax does). A schedule keeps ``(count,)``; a mask is
    not ported."""
    if mask is not None:
        raise NotImplementedError(
            "a weight-decay mask (optax.masked) is not ported")

    def init(params):
        return (_count(params),) if callable(weight_decay) else ()

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        s = weight_decay(state[0]) if callable(weight_decay) else weight_decay
        return tree_map(lambda g, p: g + s * p, updates, params), state

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False,
          accumulator_dtype: torch.dtype | None = None
          ) -> GradientTransformation:
    """``optax.trace`` (momentum): state ``(trace,)``."""

    def init(params):
        return (_zeros_like(params, accumulator_dtype),)

    def update(updates, state, params=None):
        def f(g, t):
            return g + decay * t

        new_trace = tree_map(f, updates, state[0])
        out = tree_map(f, updates, new_trace) if nesterov else new_trace
        if accumulator_dtype is not None:
            new_trace = tree_map(lambda t: t.to(accumulator_dtype), new_trace)
        return out, (new_trace,)

    return GradientTransformation(init, update)


def ema(decay: float, debias: bool = True,
        accumulator_dtype: torch.dtype | None = None
        ) -> GradientTransformation:
    """``optax.ema``: state ``(count, ema)``."""

    def init(params):
        return (_count(params), _zeros_like(params, accumulator_dtype))

    def update(updates, state, params=None):
        count, old = state
        new = tree_map(lambda g, t: (1 - decay) * g + decay * t, updates, old)
        count_inc = _safe_increment(count)
        out = _bias_correction(new, decay, count_inc) if debias else new
        if accumulator_dtype is not None:
            new = tree_map(lambda t: t.to(accumulator_dtype), new)
        return out, (count_inc, new)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: leaves kept where the global norm is
    below ``max_norm``, else ``(t / norm) * max_norm`` (a placed leaf
    piece by piece)."""

    def clip(t, trigger, g_norm):
        return torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        out = tree_map(
            lambda t: map_pieces(clip, t, trigger, g_norm)
            if isinstance(t, Sharded) else clip(t, trigger, g_norm),
            updates)
        return out, state

    return GradientTransformation(_empty, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    """``optax.clip_by_block_rms``: each leaf over ``max(1, rms / t)``."""

    def clip(u):
        denom = torch.clamp(torch.sqrt(torch.mean(u * u)) / threshold,
                            min=1.0)
        return u / denom

    return GradientTransformation(
        _empty, lambda u, s, p=None: (tree_map(clip, u), s))


def scale_by_param_block_rms(min_scale: float = 1e-3) -> GradientTransformation:
    """``optax.scale_by_param_block_rms``: each update times its param's
    root mean square, at least ``min_scale``."""

    def rms(p):
        r = torch.sqrt(torch.mean(p * p))
        x = torch.where(r <= min_scale, torch.ones_like(p), p)
        return torch.where(r <= min_scale,
                           torch.tensor(min_scale, dtype=r.dtype,
                                        device=r.device),
                           torch.sqrt(torch.mean(x * x)))

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs the params")
        return tree_map(lambda u, p: u * rms(p), updates, params), state

    return GradientTransformation(_empty, update)


def _factored_dims(shape, factored: bool, min_dim: int):
    """optax's ``_factored_dims``: the two largest dims, when the second
    largest reaches ``min_dim``."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms(factored: bool = True, decay_rate: float = 0.8,
                          step_offset: int = 0,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> GradientTransformation:
    """``optax.scale_by_factored_rms`` (Adafactor's second moments): state
    ``(count, v_row, v_col, v)``, each a tree of the params' structure
    whose unused entries are zeros of shape ``(1,)``, as in optax."""

    def init(params):
        def one(p):
            z1 = torch.zeros((1,), dtype=p.dtype, device=p.device)
            dims = _factored_dims(tuple(p.shape), factored,
                                  min_dim_size_to_factor)
            if dims is None:
                return (z1, z1.clone(), torch.zeros_like(p))
            d1, d0 = dims
            vr = [s for i, s in enumerate(p.shape) if i != d0]
            vc = [s for i, s in enumerate(p.shape) if i != d1]
            return (p.new_zeros(vr), p.new_zeros(vc), z1)

        res = tree_map(one, params)
        return (_count(params), tree_map(lambda r: r[0], res),
                tree_map(lambda r: r[1], res), tree_map(lambda r: r[2], res))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("scale_by_factored_rms needs the params")
        count, v_row, v_col, v = state
        t = (count - step_offset + 1).to(torch.float32)
        decay_t = 1.0 - t ** (-decay_rate)

        def one(g, vr, vc, vv, p):
            dt = p.dtype
            z1 = torch.zeros((1,), dtype=dt, device=p.device)
            dims = _factored_dims(tuple(p.shape), factored,
                                  min_dim_size_to_factor)
            gs = g * g + epsilon
            if dims is not None:
                d1, d0 = dims
                new_vr = (decay_t * vr + (1.0 - decay_t)
                          * torch.mean(gs, dim=d0)).to(dt)
                new_vc = (decay_t * vc + (1.0 - decay_t)
                          * torch.mean(gs, dim=d1)).to(dt)
                red_d1 = d1 - 1 if d1 > d0 else d1
                rc_mean = torch.mean(new_vr, dim=red_d1, keepdim=True)
                row_factor = (new_vr / rc_mean) ** -0.5
                col_factor = new_vc ** -0.5
                u = (g * row_factor.unsqueeze(d0)
                     * col_factor.unsqueeze(d1))
                return (u, new_vr, new_vc, z1)
            new_v = (decay_t * vv + (1.0 - decay_t) * gs).to(dt)
            return (g * new_v ** -0.5, z1, z1.clone(), new_v)

        res = tree_map(one, grads, v_row, v_col, v, params)
        pick = [tree_map(lambda r, i=i: r[i], res) for i in range(4)]
        return pick[0], (_safe_increment(count), pick[1], pick[2], pick[3])

    return GradientTransformation(init, update)


def masked(inner: GradientTransformation, mask) -> GradientTransformation:
    """``optax.masked``: ``inner`` runs on the leaves ``mask`` marks True
    (a tree of bools, or a function of the params giving one); the others
    pass through unchanged. State ``(inner_state,)``, the inner state over
    the masked tree, where None stands for optax's ``MaskedNode``."""

    def mask_of(tree):
        return mask(tree) if callable(mask) else mask

    def keep(tree, m):
        return tree_map(lambda x, on: x if on else None, tree, m)

    def init(params):
        return (inner.init(keep(params, mask_of(params))),)

    def update(updates, state, params=None):
        m = mask_of(updates)
        new, inner_state = inner.update(
            keep(updates, m), state[0],
            None if params is None else keep(params, m))
        out = tree_map(lambda u, n, on: n if on else u, updates, new, m)
        return out, (inner_state,)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: the state is the tuple of the stages' states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        if len(state) != len(transforms):
            raise ValueError("chain state does not match its transforms")
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


# -- the aliases make_optimizer uses --------------------------------------
def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: torch.dtype | None = None, weight_decay: float = 1e-4,
          mask: Any = None, *, nesterov: bool = False
          ) -> GradientTransformation:
    """``optax.adamw``: Adam, then the decoupled ``weight_decay * p``,
    then ``-learning_rate``."""
    return chain(
        scale_by_adam(b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                      mu_dtype=mu_dtype, nesterov=nesterov),
        add_decayed_weights(weight_decay, mask),
        scale_by_learning_rate(learning_rate),
    )


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0,
         mu_dtype: torch.dtype | None = None, *, nesterov: bool = False
         ) -> GradientTransformation:
    """``optax.adam``: Adam, then ``-learning_rate``."""
    return chain(
        scale_by_adam(b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                      mu_dtype=mu_dtype, nesterov=nesterov),
        scale_by_learning_rate(learning_rate),
    )


def sgd(learning_rate, momentum: float | None = None, nesterov: bool = False,
        accumulator_dtype: torch.dtype | None = None
        ) -> GradientTransformation:
    """``optax.sgd``, with optional (Nesterov) momentum."""
    opt = (trace(decay=momentum, nesterov=nesterov,
                 accumulator_dtype=accumulator_dtype)
           if momentum is not None else identity())
    return chain(opt, scale_by_learning_rate(learning_rate))


def adafactor(learning_rate=None, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, decay_offset: int = 0,
              multiply_by_parameter_scale: bool = True,
              clipping_threshold: float | None = 1.0,
              momentum: float | None = None,
              dtype_momentum: torch.dtype = torch.float32,
              weight_decay_rate: float | None = None, eps: float = 1e-30,
              factored: bool = True, weight_decay_mask: Any = None
              ) -> GradientTransformation:
    """``optax.adafactor``."""
    tx = [scale_by_factored_rms(factored, decay_rate, decay_offset,
                                min_dim_size_to_factor, eps)]
    if clipping_threshold is not None:
        tx.append(clip_by_block_rms(clipping_threshold))
    if learning_rate is not None:
        tx.append(scale_by_learning_rate(learning_rate, flip_sign=False))
    if multiply_by_parameter_scale:
        tx.append(scale_by_param_block_rms())
    if momentum is not None:
        tx.append(ema(momentum, debias=False,
                      accumulator_dtype=dtype_momentum))
    if weight_decay_rate is not None:
        tx.append(add_decayed_weights(weight_decay_rate,
                                      mask=weight_decay_mask))
    tx.append(scale(-1))
    return chain(*tx)


__all__ = [
    "GradientTransformation", "adafactor", "adam", "add_decayed_weights",
    "adamw", "apply_updates", "chain", "clip_by_block_rms", "clip_by_global_norm",
    "ema", "global_norm", "identity", "masked", "scale", "scale_by_adam",
    "scale_by_factored_rms", "scale_by_learning_rate",
    "scale_by_param_block_rms", "scale_by_schedule", "sgd", "trace",
    "tree_leaves", "tree_map", "tree_unflatten",
]
