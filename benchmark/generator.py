"""The one traffic generator: every mix is a data file it reads.

A mix (``benchmark/traffic/<mix>.json``) names length distributions, how
prompts share prefixes and how requests sample. The generator makes one
request stream per client; request ``r`` of client ``c`` is drawn from
``(seed, r, c)`` alone, so a stream is endless and the same seed gives the
same streams.

Sizes are stratified: in round ``r`` the clients' requests take the
distributions' quantiles at ``(k + 0.5) / n`` for ``k < n`` (``n``
clients). Which output length and think time go with which prompt length
is drawn per round from a fixed seed, and the requests are dealt out to
the clients in an order drawn from the run's seed. Every seed therefore
sends the same set of requests in each round, in another order, and
seeds differ in which client sends which and in the token ids.

Keys of a mix:

- ``prompt_len``: the prompt's length, or with ``document`` the
  question's; ``output_len``: tokens asked for (no stop ids). Each is
  ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
  ``{"dist": "uniform", "min", "max"}``.
- ``system_prefix`` (optional): ``{"share", "count", "len"}``: the
  ``share`` of each round's longest prompts open with one of ``count``
  shared prompts of ``len`` tokens.
- ``document`` (optional): ``{"len", "asks"}``: each client runs
  sessions; a session draws a document of ``len`` tokens and asks
  ``asks`` questions of it in turn (prompt = document + question).
  Sessions are staggered: client ``c`` starts with ``asks - c % asks``
  questions left on its first document, and set-up prefills each
  client's first document, so the window starts with documents cached
  and new ones arriving as they would in steady state.
- ``think_s`` (optional): the seconds a client waits before sending
  each request, ``{"dist": "uniform", "min", "max"}``; it spreads
  arrivals over the engine's chunk boundaries as people reading and
  typing do.
- ``greedy_share``: the share of each round's requests decoded greedily;
  the others sample with ``sampled`` (``temperature``, ``top_k``,
  ``top_p``).
- ``settle_s`` (read by the harness): seconds of the clients' traffic
  before the window opens, so that it opens on a loop whose clients no
  longer send in step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

_SALT = {"round": 1, "ids": 2, "doc": 3, "system": 4, "warm": 5,
         "pairs": 6}
# the seed the pairing of sizes is drawn from, the same for every run
_PAIR_SEED = 0


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int
    greedy: bool
    knobs: dict = field(default_factory=dict)
    think_s: float = 0.0


def midpoints(dist: dict, n: int) -> list[float]:
    """The ``n`` stratum midpoints of ``dist``, clipped."""
    lo, hi = float(dist["min"]), float(dist["max"])
    ps = [(k + 0.5) / n for k in range(n)]
    if dist["dist"] == "lognormal":
        z = NormalDist()
        vals = [float(dist["median"]) * math.exp(float(dist["sigma"])
                                                 * z.inv_cdf(p)) for p in ps]
    elif dist["dist"] == "uniform":
        vals = [lo + p * (hi - lo) for p in ps]
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return [min(max(v, lo), hi) for v in vals]


def quantiles(dist: dict, n: int) -> list[int]:
    """The ``n`` stratum midpoints of ``dist``, rounded."""
    return [int(round(v)) for v in midpoints(dist, n)]


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *keys]))


def spread(share: float, n: int) -> list[bool]:
    """``round(share * n)`` of ``n`` strata marked, evenly spread."""
    return [math.floor((k + 1) * share) > math.floor(k * share)
            for k in range(n)]


class Traffic:
    def __init__(self, mix: dict, vocab: int, n_clients: int, seed: int):
        self.mix, self.vocab, self.n, self.seed = mix, int(vocab), \
            int(n_clients), int(seed)
        self.doc = mix.get("document")
        self.sys = mix.get("system_prefix")
        self._prompt_q = quantiles(mix["prompt_len"], self.n)
        self._out_q = quantiles(mix["output_len"], self.n)
        self._think_q = (midpoints(mix["think_s"], self.n)
                         if mix.get("think_s") else [0.0] * self.n)
        self._greedy = spread(float(mix.get("greedy_share", 1.0)), self.n)
        self._sampled = dict(mix.get("sampled") or {})
        self._rounds: dict[int, tuple] = {}
        self._system = None
        if self.sys:
            g = _rng(seed, _SALT["system"])
            self._system = [
                g.integers(0, self.vocab, int(self.sys["len"])).tolist()
                for _ in range(int(self.sys["count"]))
            ]

    def _round(self, r: int) -> tuple:
        """Round ``r``: each client's prompt stratum, and the output and
        think strata that go with each prompt stratum."""
        got = self._rounds.get(r)
        if got is None:
            pairs = _rng(_PAIR_SEED, _SALT["pairs"], r)
            got = (_rng(self.seed, _SALT["round"], r).permutation(self.n),
                   pairs.permutation(self.n), pairs.permutation(self.n))
            self._rounds[r] = got
        return got

    def _ids(self, n: int, *keys: int) -> list[int]:
        return _rng(self.seed, *keys).integers(0, self.vocab, n).tolist()

    def _document(self, c: int, session: int) -> list[int]:
        return self._ids(int(self.doc["len"]), _SALT["doc"], c, session)

    def _session_of(self, c: int, r: int) -> int:
        """The session that request ``r`` of client ``c`` belongs to."""
        asks = int(self.doc["asks"])
        first = asks - c % asks
        return 0 if r < first else 1 + (r - first) // asks

    def request(self, c: int, r: int) -> Request:
        """Request ``r`` of client ``c``."""
        perm, out_of, think_of = self._round(r)
        kp = int(perm[c])
        n_prompt = self._prompt_q[kp]
        n_out = self._out_q[int(out_of[kp])]
        greedy = self._greedy[kp]
        ids = self._ids(n_prompt, _SALT["ids"], r, c)
        if self.doc:
            ids = self._document(c, self._session_of(c, r)) + ids
        elif self.sys:
            n_shared = round(float(self.sys["share"]) * self.n)
            if kp >= self.n - n_shared:
                which = (kp - (self.n - n_shared)) % len(self._system)
                sp = self._system[which]
                ids = sp + ids[len(sp):]
        knobs = {} if greedy else dict(self._sampled)
        return Request(prompt=ids, max_new_tokens=n_out, greedy=greedy,
                       knobs=knobs, think_s=self._think_q[int(think_of[kp])])

    def stream(self, c: int):
        """Client ``c``'s endless request stream."""
        r = 0
        while True:
            yield self.request(c, r)
            r += 1

    def prewarm_prompts(self) -> list[list[int]]:
        """The prompts set-up prefills before the window: each client's
        first document where the mix has documents."""
        if not self.doc:
            return []
        return [self._document(c, 0) for c in range(self.n)]

    def warmup_requests(self, prompt_len: int, new_tokens: int) -> list[Request]:
        """One request per client of ``prompt_len`` tokens and
        ``new_tokens`` outputs, half of them sampling, to run every shape
        of the serving step before the window."""
        g = _rng(self.seed, _SALT["warm"])
        return [
            Request(prompt=g.integers(0, self.vocab, prompt_len).tolist(),
                    max_new_tokens=new_tokens, greedy=c % 2 == 0,
                    knobs={} if c % 2 == 0 else dict(self._sampled))
            for c in range(self.n)
        ]
