"""90th percentile of submit to first token, over the requests whose first
token arrived inside the window."""

from benchmark import stats


def read(rec):
    return stats.percentile(stats.ttft_ms(rec), 90)
