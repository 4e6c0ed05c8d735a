"""Serving engine: the paged KV cache and unified step, sampling, the
scheduler, and the continuous-batching engine."""
