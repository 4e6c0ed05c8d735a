"""90th percentile of each finished request's time per output token after
the first: (last - first) / (tokens - 1)."""

from benchmark import stats


def read(rec):
    return stats.percentile(stats.tpot_ms(rec), 90)
