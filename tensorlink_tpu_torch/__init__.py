"""PyTorch/CUDA port of :mod:`tensorlink_tpu`.

The JAX package stays the reference; this package re-implements its
serving main path — the single-device continuous-batching loop
(``ml/batching.py::ContinuousBatcher`` → ``engine/continuous.py::
ContinuousEngine`` → ``engine/paged.py::paged_ragged_step``) — in plain
PyTorch, over full-precision, int8 or packed-int4 KV pages and bf16 or
weight-only int8 weights, with the Pallas attention kernels that path
runs (and ``paged_prefill_attention``) replaced by CUDA C++ kernels
written for Hopper (``ops/csrc/``).

Module and function names mirror the JAX package, so each piece has an
obvious counterpart there. The port imports ``torch``, never ``jax``, and
nothing of ``tensorlink_tpu``. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""
