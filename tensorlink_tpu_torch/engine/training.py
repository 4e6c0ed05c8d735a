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

Not ported: the ZeRO-1 sharded step (``zero1``, ``tp_axis``) and
``optimizer_state_specs`` (ROADMAP queue 1 item 3). ``donate`` is
accepted and ignored: the step returns new tensors either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .. import unported
from ..models.base import ModelConfig
from ..models.transformer import forward
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
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    if loss_mask is not None:
        mask = loss_mask[:, 1:].bool()
    else:
        mask = torch.ones_like(targets, dtype=torch.bool)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    n = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / n
    return loss, {"loss": loss, "n_tokens": n}


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
    """A train step and its optimizer (the unsharded step; ZeRO-1 waits
    for ROADMAP queue 1 item 3)."""

    step_fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    optimizer: Any

    def init_state(self, params):
        return self.optimizer.init(params)

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
    tensors, the metrics as 0-d tensors on the params' device."""
    if zero1:
        raise unported("the ZeRO-1 sharded train step (zero1)", 3)
    if tp_axis is not None:
        raise unported("the tensor-parallel train step (tp_axis)", 3)
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


def optimizer_state_specs(*_args, **_kwargs):
    """Sharding specs of the optimizer state (ZeRO-1): not ported."""
    raise unported("optimizer state sharding (optimizer_state_specs)", 3)


__all__ = [
    "ChainedOptimizer",
    "TrainStep",
    "causal_lm_loss",
    "make_optimizer",
    "make_train_step",
    "optimizer_state_specs",
]
