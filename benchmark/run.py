"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from spans, counters
and a profiler trace of the window's last seconds. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, then ``gap_stats`` and ``checks``); the last lines of
standard error repeat each compared number beside its limit.

``--control`` serves with the program's int8 path (int8 weights and KV
pages): the lower-precision control a limit was set against. It is for
setting limits, and its runs are expected to come out not correct.

Exits 2 without a result where CUDA or the cell's cards are missing, and
3 where JAX, jaxlib, flax or the JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorlink_tpu")


def cache_env(root: Path) -> None:
    """Every kernel and build cache inside the checkout, at fixed paths;
    no library may load JAX on its own."""
    cache = root / "build" / "bench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``tensorlink_tpu_torch`` is not ``tensorlink_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    faulthandler.enable()
    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    import torch

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    out = harness.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_start=T_START, control=args.control)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']} {rel} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
