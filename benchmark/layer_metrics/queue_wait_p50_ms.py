"""Median wait from submit to admission into a slot: the slot engine's
``queue_wait`` spans of the requests submitted inside the window (every
request of the traced run carries a trace id)."""

from benchmark import stats


def read(rec):
    waits = [s["dur_ms"] for r in rec["requests"]
             if stats.in_window(rec, r["t_sub"])
             for s in r["spans"] if s["name"] == "queue_wait"]
    return stats.percentile(waits, 50)
