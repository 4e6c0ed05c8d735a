"""Serve-and-train (port of ``tensorlink_tpu/engine/serve_train.py``).

:class:`ServeTrainLoop` owns a train step (``engine/training.py``), its
params and optimizer state, and a data source; it attaches to a local
:class:`ContinuousBatcher` as the driver's background hook, so every
train step runs ON the serving driver thread BETWEEN engine chunks:

- **best_effort class**: each tick yields while the engine holds any
  live or queued request ranked above best_effort
  (``ContinuousEngine.foreground_work``), so an interactive arrival waits
  at most one train step.
- **live weight publish**: every ``publish_every`` steps the trained
  params hot-swap into the serving engine at the chunk boundary
  (``ContinuousEngine.publish_weights``, which copies the tree onto the
  engine's device, so the trainer's later steps never touch what serves),
  versioned, with no dropped stream. ``on_publish`` lets a caller
  propagate the version elsewhere.
- **telemetry**: ``train_steps``/``weights_published`` counters and
  ``train_step_ms``/``train_mfu`` gauges ride the engine's registry and
  serving snapshot.

The tick runs on the dispatcher thread, so ``publish_weights`` and the
engine reads need no locks.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from ..core.logging import get_logger


class ServeTrainLoop:
    """Background fine-tuning against a serving ContinuousBatcher.

    ``data_fn(step) -> batch | None`` supplies each step's batch (dict
    with "tokens" [B, T] and optional "loss_mask"); ``None`` ends the
    run. ``peak_flops`` (device peak, FLOP/s) makes the ``train_mfu``
    gauge meaningful; 0 reports 0.0. ``publish_every=0`` trains without
    publishing (an explicit ``publish_now()`` still works — e.g. one
    publish at end-of-run).
    """

    def __init__(
        self,
        batcher: Any,
        train_step: Any,  # engine.training.TrainStep
        params: Any,
        *,
        data_fn: Callable[[int], dict | None],
        opt_state: Any = None,
        publish_every: int = 0,
        max_steps: int = 0,
        peak_flops: float = 0.0,
        cfg: Any = None,  # ModelConfig, for the 6·N·B·T MFU estimate
        yield_above: str = "best_effort",
        on_publish: Callable[[int, Any], None] | None = None,
    ):
        if getattr(batcher, "_cont", None) is None:
            raise ValueError(
                "serve-and-train needs a local-engine ContinuousBatcher"
            )
        self.batcher = batcher
        self.train_step = train_step
        self.params = params
        self.opt_state = (
            opt_state if opt_state is not None
            else train_step.init_state(params)
        )
        self.data_fn = data_fn
        self.publish_every = int(publish_every)
        self.max_steps = int(max_steps)
        self.peak_flops = float(peak_flops)
        self.cfg = cfg
        self.yield_above = str(yield_above)
        self.on_publish = on_publish
        self.step = 0
        self.publishes = 0
        self.done = False
        self.last_loss = float("nan")
        self.last_step_ms = 0.0
        self.log = get_logger("engine.serve_train")

    # -- lifecycle -------------------------------------------------------
    def attach(self) -> "ServeTrainLoop":
        """Install the tick as the batcher's background hook."""
        self.batcher.set_background(self.tick)
        return self

    def detach(self) -> None:
        self.batcher.set_background(None)

    # -- the background tick (runs ON the serving driver thread) ---------
    def tick(self) -> bool:
        """Run at most one train step; True when a step ran (the driver
        keeps the loop hot). Yields — runs nothing — while the engine
        holds work ranked above ``yield_above``, or once done."""
        if self.done:
            return False
        cont = getattr(self.batcher, "_cont", None)
        if cont is None:
            self.done = True
            return False
        if cont.foreground_work(self.yield_above):
            return False
        batch = self.data_fn(self.step)
        if batch is None:
            self.done = True
            self.detach()
            return False
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.train_step.step_fn(
            self.params, self.opt_state, batch
        )
        loss = float(metrics["loss"])  # waits for the step's device work
        dt = time.perf_counter() - t0
        self.step += 1
        self.last_loss = loss
        self.last_step_ms = dt * 1e3
        mfu = 0.0
        if self.peak_flops > 0 and self.cfg is not None:
            toks = batch["tokens"]
            flops = 6.0 * self.cfg.param_count() * toks.shape[0] * toks.shape[1]
            mfu = flops / max(dt, 1e-9) / self.peak_flops
        cont.note_train_step(dt * 1e3, mfu)
        if self.max_steps and self.step >= self.max_steps:
            self.done = True
            self.detach()
        if self.publish_every and self.step % self.publish_every == 0:
            self.publish_now()
        return True

    def publish_now(self) -> int:
        """Hot-swap the CURRENT trained params into the serving engine.
        Driver-thread only (the tick calls it; external callers go
        through ``batcher.publish_weights``). The engine copies the tree
        onto its device, and a train step returns new tensors, so later
        steps never change what serves."""
        cont = getattr(self.batcher, "_cont", None)
        if cont is None:
            raise RuntimeError("serving engine is gone")
        staged = self.params
        version = cont.publish_weights(staged)
        self.publishes += 1
        self.log.info(
            "published weights v%d after train step %d (loss %.4f)",
            version, self.step, self.last_loss,
        )
        if self.on_publish is not None:
            try:
                self.on_publish(version, staged)
            except Exception:
                # propagation is best-effort: the local engine already
                # serves the new version
                self.log.exception("on_publish propagation failed")
        return version


__all__ = ["ServeTrainLoop"]
