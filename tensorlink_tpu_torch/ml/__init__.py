"""Serving front-ends (``ml/batching.py``)."""
