"""Attention for the paged serving step: plain versions and the CUDA
kernel wrappers (``ops/attention.py``), the kernels' sources
(``ops/csrc/``) and their build (``ops/_build.py``)."""
