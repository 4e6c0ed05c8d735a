"""Share of prompt tokens served from the prefix cache over the window:
``prefill_tokens_skipped / (prefill_tokens + prefill_tokens_skipped)``,
in percent."""

from benchmark import stats


def read(rec):
    skipped = stats.counter_delta(rec, "prefill_tokens_skipped")
    total = skipped + stats.counter_delta(rec, "prefill_tokens")
    return 100.0 * skipped / total if total > 0 else None
