"""Shared speculative-decoding policy: prompt-lookup drafting + the
acceptance-rate kill switch (the port's copy of
``tensorlink_tpu/engine/spec.py``, which imports no JAX; kept line for
line so the two packages draft and gate alike).

The B=1 greedy path (``engine/generate.py::generate_lookahead``, the
``{"lookahead": true}`` API hint) drafts with :func:`lookup_draft` and
gates itself through a :class:`SpecController`. In the JAX package the
continuous engine's ``spec_decode`` path uses the same policy; that path
waits for the speculative-decoding slice of the port.

The policy is the README's "never a slowdown" evidence (VERDICT r4/r5):
drafting is host-side and model-free (prompt-lookup n-grams — zero model
cost), so the ONLY way speculation loses is a padded verify pass whose
drafts keep missing or keep being rejected. Three guards close that:

- **prompt prescan**: prompt-lookup can only ever draft from a RECURRING
  n-gram, so a history with zero repeated adjacent token pairs starts
  with speculation off (re-armed on the first recurring pair when the
  generated text turns repetitive);
- **miss-run disarm**: :data:`MISS_OFF` consecutive draft misses mean
  the text is not repetitive — stop looking;
- **acceptance-rate kill switch**: after :data:`ACC_PROBE` verify passes
  a measured EMA acceptance below :data:`MIN_TOKENS_PER_PASS` tokens per
  pass cannot beat plain decode even if the padded pass were free — the
  request falls back to 1-token decode PERMANENTLY (the kill never
  re-probes; re-arming after a measured loss would reinstate the
  slowdown it stopped).
"""

from __future__ import annotations

from typing import Callable, Sequence

# draft search knobs (prompt-lookup n-gram matching)
NGRAM = 8
MIN_NGRAM = 2
HISTORY_SCAN_LIMIT = 4096  # bound the backward scan on long histories

# acceptance-rate kill switch (shared constants — the legacy path and
# the ragged path must fire at the same measured acceptance)
ACC_PROBE = 4  # verify passes before the acceptance EMA may kill
MIN_TOKENS_PER_PASS = 1.5  # below this, drafting cannot pay for itself
ACC_EMA = 0.5  # EMA weight on the newest pass

# a run of this many consecutive draft MISSES disarms speculation (the
# text isn't repetitive; a miss never produces a verify sample for the
# acceptance rule, so waiting for the kill switch would wait forever)
MISS_OFF = 8


def lookup_draft(
    history: Sequence[int], n_draft: int,
    ngram: int = NGRAM, min_ngram: int = MIN_NGRAM,
) -> list[int]:
    """Prompt-lookup drafting: if the trailing n-gram occurred earlier in
    the token history, propose the tokens that followed it. Free — no
    draft model; strong on repetitive/extractive text.

    Longest suffix first: an 8-gram match predicts the continuation far
    better than a 1-gram, and on a fixed-shape verify pass a longer draft
    costs nothing extra — so precision is the only lever. ``min_ngram=2``
    refuses single-token matches outright: "the occurred before" is
    noise, and every wrong draft still consumes a (padded) verify pass
    where a plain decode step would have done."""
    history = list(history)
    lo = max(0, len(history) - HISTORY_SCAN_LIMIT)
    for n in range(min(ngram, len(history) - 1), min_ngram - 1, -1):
        tail = history[-n:]
        # most recent earlier occurrence
        for start in range(len(history) - n - 1, lo - 1, -1):
            if history[start : start + n] == tail:
                nxt = history[start + n : start + n + n_draft]
                if nxt:
                    return nxt
                break
    return []


def spec_worthwhile(tokens_per_pass: float, t_verify: float,
                    t_decode: float) -> bool:
    """Speculation continues only while its measured throughput beats
    vanilla: tokens_per_pass/t_verify vs 1/t_decode. Pure so the
    break-even rule is unit-testable without wall-clock flakiness."""
    if t_verify <= 0 or t_decode <= 0:
        return True  # no signal yet
    return tokens_per_pass / t_verify >= 1.0 / t_decode


class SpecController:
    """Per-request drafting state machine (prescan / miss-run / re-arm /
    acceptance kill) shared by the legacy lookahead loop and the
    continuous engine's per-slot drafting.

    Lifecycle: :meth:`prescan` once over the initial history, then
    :meth:`draft` before every verify opportunity (it tracks misses and
    disarms itself), :meth:`note_pair` per emitted token (re-arms on
    recurring text when ``rearm``), :meth:`note_verify` after every
    verify pass (acceptance EMA + the permanent kill). ``draft_fn`` is
    injectable so the legacy engine's ``_lookup_draft`` staticmethod
    stays the override point its tests patch."""

    def __init__(
        self,
        n_draft: int = NGRAM,
        *,
        rearm: bool = True,
        draft_fn: Callable[..., list[int]] | None = None,
    ):
        self.n_draft = max(int(n_draft), 1)
        self._draft_fn = draft_fn or lookup_draft
        self._rearm = bool(rearm)
        self.on = True  # currently drafting (prescan/miss/kill can clear)
        self.dead = False  # kill switch fired: PERMANENT for the request
        self.miss_run = 0
        self.ema_acc: float | None = None
        self.verify_passes = 0
        # lifetime telemetry (the engine's spec_* counters read these)
        self.drafted = 0
        self.accepted = 0
        self._pairs: set[tuple[int, int]] = set()

    @property
    def active(self) -> bool:
        return self.on and not self.dead

    def prescan(self, history: Sequence[int]) -> bool:
        """Seed the adjacent-pair set from the initial history; a history
        with zero recurring pairs starts with speculation OFF (prompt-
        lookup could never draft from it). Returns the armed state."""
        rep = False
        hist = list(history)
        for a, b in zip(hist, hist[1:]):
            if (a, b) in self._pairs:
                rep = True
            else:
                self._pairs.add((a, b))
        if not rep:
            self.on = False
        return self.on

    def note_pair(self, a: int, b: int) -> None:
        """Observe one emitted-token transition. A RECURRING pair on a
        re-armable request switches drafting back on (the generated text
        became repetitive) — unless the kill switch already fired."""
        pr = (int(a), int(b))
        if pr in self._pairs:
            if not self.on and not self.dead and self._rearm:
                self.on = True
                self.miss_run = 0
        else:
            self._pairs.add(pr)

    def draft(self, history: Sequence[int], cap: int | None = None) -> list[int]:
        """Propose up to ``min(n_draft, cap)`` draft tokens, or [] on a
        miss (tracked: :data:`MISS_OFF` consecutive misses disarm). The
        ``drafted`` telemetry is NOT counted here — a caller packing
        under a draft budget may truncate or deny the proposal, so it
        credits ``drafted`` with what was actually GRANTED (the engine's
        ``_pack_drafts``; the legacy loop grants everything)."""
        if not self.active:
            return []
        k = self.n_draft if cap is None else min(int(cap), self.n_draft)
        if k <= 0:
            return []
        d = self._draft_fn(history, k)
        if not d:
            self.miss_run += 1
            if self.miss_run >= MISS_OFF:
                self.on = False
            return []
        self.miss_run = 0
        return d[:k]

    def note_verify(self, per_pass: int) -> bool:
        """Record one verify pass that emitted ``per_pass`` tokens
        (accepted drafts + the bonus/correction token). Returns True when
        this pass fired the PERMANENT acceptance-rate kill switch."""
        self.accepted += max(int(per_pass) - 1, 0)
        self.verify_passes += 1
        self.ema_acc = (
            float(per_pass) if self.ema_acc is None
            else ACC_EMA * float(per_pass) + (1 - ACC_EMA) * self.ema_acc
        )
        if (
            not self.dead
            and self.verify_passes >= ACC_PROBE
            and self.ema_acc < MIN_TOKENS_PER_PASS
        ):
            self.kill()
            return True
        return False

    def kill(self) -> None:
        """Disable speculation PERMANENTLY for this request (measured
        acceptance or a caller-side timing rule said it's a loss)."""
        self.on = False
        self.dead = True

    @property
    def tokens_per_pass(self) -> float | None:
        """Lifetime mean tokens emitted per verify pass (None before the
        first pass) — the amortization number the bench/metrics report."""
        if not self.verify_passes:
            return None
        return (self.accepted + self.verify_passes) / self.verify_passes


__all__ = [
    "ACC_PROBE",
    "MIN_TOKENS_PER_PASS",
    "MISS_OFF",
    "SpecController",
    "lookup_draft",
    "spec_worthwhile",
]
