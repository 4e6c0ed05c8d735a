"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def test_top_level_names_compared_whole():
    assert forbidden_modules(["tensorlink_tpu_torch",
                              "tensorlink_tpu_torch.engine.paged",
                              "jaxtyping", "flax_like", "torch"]) == []
    assert forbidden_modules(["tensorlink_tpu.models.transformer"]) == \
        ["tensorlink_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "tensorlink_tpu"}


def imports_of(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax():
    for f in HERE.rglob("*.py"):
        assert not imports_of(f) & set(FORBIDDEN), f


def test_reference_imports_only_torch():
    for f in (HERE / "reference").glob("*.py"):
        assert imports_of(f) <= {"__future__", "dataclasses", "torch"}, f


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, in a fresh process, leaves
    no forbidden module in ``sys.modules``."""
    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import torch\n"
        "from benchmark import harness\n"
        "from benchmark.run import forbidden_modules\n"
        "from benchmark.tests.cells import tiny_cell\n"
        "cell = tiny_cell('olmo2', 'chat')\n"
        "out = harness.run(cell, seed=5, seconds=1.0, trace=False,\n"
        "                  device=torch.device('cpu'),\n"
        "                  t_start=time.monotonic())\n"
        "print(json.dumps([out['attempted'], forbidden_modules(sys.modules)]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    attempted, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert attempted > 0 and bad == []
