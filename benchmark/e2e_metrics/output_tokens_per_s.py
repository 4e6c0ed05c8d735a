"""Tokens delivered to clients inside the window, over its seconds."""

from benchmark import stats


def read(rec):
    return stats.tokens_in_window(rec) / stats.window_s(rec)
