"""What the metric readers share: the window's requests as the clients
saw them, and one percentile rule.

A request record (``harness.py``) holds ``t_sub`` (the client's call),
``times`` (each streamed token's arrival), ``t_done``, ``tokens``,
``cut`` (shed when the window closed) and ``error``. Times are the host's
monotonic clock in seconds; the window is ``rec["window"] = (t0, t1)``.
"""

from __future__ import annotations

import math


def percentile(values, q: float):
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it; None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(math.ceil(q / 100.0 * len(vals)) - 1, 0)]


def in_window(rec: dict, t: float) -> bool:
    t0, t1 = rec["window"]
    return t0 <= t <= t1


def tokens_in_window(rec: dict) -> int:
    """Tokens delivered to clients inside the window, of every request."""
    return sum(1 for r in rec["requests"] for t in r["times"]
               if in_window(rec, t))


def ttft_ms(rec: dict) -> list[float]:
    """Submit to first streamed token, of each request whose first token
    arrived inside the window."""
    return [(r["times"][0] - r["t_sub"]) * 1e3 for r in rec["requests"]
            if r["times"] and in_window(rec, r["times"][0])]


def finished(rec: dict) -> list[dict]:
    """Requests that ended inside the window with every token asked for."""
    return [r for r in rec["requests"]
            if not r["cut"] and r["error"] is None
            and in_window(rec, r["t_done"])
            and len(r["tokens"]) == r["max_new"]]


def tpot_ms(rec: dict) -> list[float]:
    """(last token - first token) / (tokens - 1), of each request that
    finished inside the window with two tokens or more."""
    return [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
            for r in finished(rec) if len(r["times"]) >= 2]


def window_s(rec: dict) -> float:
    t0, t1 = rec["window"]
    return t1 - t0


def counter_delta(rec: dict, key: str) -> int:
    return rec["counters"]["end"][key] - rec["counters"]["start"][key]
