"""``tpot_p90_ms`` read where the card idles most of the window, so the
host paces it: the same definition, reported as a per-layer metric."""

from benchmark import stats


def read(rec):
    return stats.percentile(stats.tpot_ms(rec), 90)
