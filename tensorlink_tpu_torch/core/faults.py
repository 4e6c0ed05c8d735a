"""Deterministic fault injection (port of ``tensorlink_tpu/core/faults.py``).

A :class:`FaultPlan` is a *seeded* list of rules keyed on named sites. Each
rule says *what* goes wrong at a site (drop / delay / duplicate / crash /
error) and *when* (the nth matching call, or a seeded coin flip). Given the
same seed and the same call sequence a plan makes identical decisions every
run.

The site registry (:data:`SITES`) is the JAX package's, name for name, so a
plan written for one package loads in the other. The port wires the
host-RAM prefix tier's sites (``engine/continuous.py``):

- ``kvtier.demote`` — a refcount-0 prefix page demoting to the host tier
  (``_demote_page``); error: the page is destroyed instead; crash.
- ``kvtier.fetch`` — a host-tier promote, a fleet prefix pull, or a prefix
  export at admission (``_promote_chain``, ``_pull_chain``,
  ``export_prefix_pages``); error: the rung degrades to the next (fleet
  pull, then prefill); crash.

The other sites belong to layers not yet ported (node transport, worker,
validator, journal). A rule naming an unknown site fails loudly at plan
construction. Zero overhead when disabled: every site is guarded by
``if faults.ENABLED:``, a module bool that is False unless a plan was
installed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

OPS = ("drop", "delay", "dup", "crash", "error")

# The registered fault-site names — every site wired in the stack. A rule
# naming anything else raises at construction (FaultRule.__post_init__),
# so a typo'd chaos config fails the test that installs it instead of
# silently injecting nothing.
SITES = (
    "p2p.send",
    "connection.frame",
    "worker.session_step",
    "worker.train_step",
    "worker.cont_step",
    "worker.drain",
    "migrate.export",
    "migrate.wire",
    "migrate.import",
    "worker.handoff",
    "validator.crash",
    "control.frame",
    "journal.write",
    "kvtier.demote",
    "kvtier.fetch",
)


class FaultInjected(RuntimeError):
    """An injected *recoverable* failure (op="error")."""


class FaultCrash(BaseException):
    """An injected node death (op="crash"). Derives from BaseException so
    generic ``except Exception`` error-reply paths cannot swallow it — the
    run loop that catches it must take the node down, not answer the
    request."""


@dataclass
class FaultRule:
    site: str
    op: str  # drop | delay | dup | crash | error
    nth: int | None = None  # fire on exactly the nth MATCHING call (1-based)
    prob: float = 0.0  # else: fire with this seeded probability
    delay_s: float = 0.05
    key_substr: str = ""  # only calls whose key contains this substring
    max_fires: int | None = 1  # None = unlimited
    # mutable per-run state
    seen: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown fault op {self.op!r} (want one of {OPS})")
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} — registered sites: "
                f"{', '.join(SITES)} (a typo here would make the rule a "
                "silent no-op)"
            )


@dataclass
class FaultPlan:
    seed: int = 0
    rules: list[FaultRule] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        rules = []
        for r in d.get("rules", []):
            r = dict(r)
            rules.append(
                FaultRule(
                    site=r["site"],
                    op=r["op"],
                    nth=r.get("nth"),
                    prob=float(r.get("prob", 0.0)),
                    delay_s=float(r.get("delay_s", 0.05)),
                    key_substr=str(r.get("key_substr", "")),
                    max_fires=r.get("max_fires", 1),
                )
            )
        return cls(seed=int(d.get("seed", 0)), rules=rules)

    def _coin(self, site: str, n: int) -> float:
        """Deterministic uniform in [0, 1) for the nth call at a site —
        a hash, not an RNG stream, so interleaved sites never perturb each
        other's draws."""
        h = hashlib.sha256(f"{self.seed}:{site}:{n}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64

    def inject(self, site: str, key: str = ""):
        """Decide this call's fate. Returns ``None`` (proceed), ``"drop"``,
        ``"dup"``, or ``("delay", seconds)``; raises :class:`FaultInjected`
        (op="error") or :class:`FaultCrash` (op="crash").

        Every matching rule counts every call (so interleaved rules keep
        deterministic nth semantics); the FIRST rule that fires decides the
        action."""
        decided: FaultRule | None = None
        for r in self.rules:
            if r.site != site:
                continue
            if r.key_substr and r.key_substr not in key:
                continue
            r.seen += 1
            if decided is not None:
                continue  # shadowed by an earlier rule, but still counted
            if r.max_fires is not None and r.fires >= r.max_fires:
                continue
            if r.nth is not None:
                fire = r.seen == r.nth
            else:
                fire = self._coin(site, r.seen) < r.prob
            if not fire:
                continue
            r.fires += 1
            decided = r
        if decided is None:
            return None
        if decided.op == "error":
            raise FaultInjected(
                f"injected fault at {site} (call {decided.seen}, key={key!r})"
            )
        if decided.op == "crash":
            raise FaultCrash(
                f"injected crash at {site} (call {decided.seen}, key={key!r})"
            )
        if decided.op == "delay":
            return ("delay", decided.delay_s)
        return decided.op  # drop | dup


# ---------------------------------------------------------------------------
# Process-global plan: the engine's sites consult it when ENABLED.
# ---------------------------------------------------------------------------

ENABLED = False
_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global ENABLED, _PLAN
    _PLAN = plan
    ENABLED = True


def uninstall() -> None:
    global ENABLED, _PLAN
    _PLAN = None
    ENABLED = False


def inject(site: str, key: str = ""):
    """Module-level dispatch for sites guarded by ``if faults.ENABLED:``."""
    if _PLAN is None:
        return None
    return _PLAN.inject(site, key)


__all__ = [
    "SITES",
    "FaultPlan",
    "FaultRule",
    "FaultInjected",
    "FaultCrash",
    "install",
    "uninstall",
    "inject",
    "ENABLED",
]
