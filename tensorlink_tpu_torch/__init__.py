"""PyTorch/CUDA port of :mod:`tensorlink_tpu`.

The JAX package stays the reference; this package re-implements its
single-device serving paths in plain PyTorch:

- continuous batching (``ml/batching.py::ContinuousBatcher`` →
  ``engine/continuous.py::ContinuousEngine`` → ``engine/paged.py::
  paged_ragged_step``) over full-precision, int8 or packed-int4 KV pages;
- the dense ``engine/generate.py::GenerationEngine`` (bucketed and
  chunked prefill, ``generate``, ``generate_compiled``,
  ``generate_chunked``, beam search, lookahead, the prompt-prefix LRU)
  over a dense fp or int8 KV cache;

with bf16 or weight-only int8 weights, and the single-worker node stack
around them: a validator (``nodes/``, ``ml/validator.py``, the HTTP API in
``api/``) plans a model onto a worker (``ml/worker.py``) over the P2P
mesh (``p2p/``), and the worker's ``ContinuousEngine`` streams tokens
back. Every Pallas attention kernel of the JAX package is replaced by a
CUDA C++ kernel written for Hopper (``ops/csrc/``): the two paged
kernels, ``paged_prefill_attention`` and ``flash_attention`` (the dense
engine's fresh-cache prefill).

Module and function names mirror the JAX package, so each piece has an
obvious counterpart there. The port imports ``torch``, never ``jax``, and
nothing of ``tensorlink_tpu``. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""


def unported(what: str, item: int) -> NotImplementedError:
    """The error a path of the JAX package that a later slice of the port
    brings raises, naming its ROADMAP queue 1 item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item})"
    )
