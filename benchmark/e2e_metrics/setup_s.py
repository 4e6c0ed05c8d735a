"""Process start to the window's first request: weights, the page pool,
warm-up, the kernels' build on a checkout's first run, and any cache the
mix prefills."""


def read(rec):
    return rec["setup_s"]
