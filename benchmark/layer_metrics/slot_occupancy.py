"""Share of slot-steps that delivered a token, over the window's chunks:
``slot_steps_live / slot_steps_total``, in percent."""

from benchmark import stats


def read(rec):
    total = stats.counter_delta(rec, "slot_steps_total")
    if total <= 0:
        return None
    return 100.0 * stats.counter_delta(rec, "slot_steps_live") / total
