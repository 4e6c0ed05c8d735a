"""The port stands alone: no module of tensorlink_tpu_torch (nor
chip_smoke.py) imports ``jax`` or anything of ``tensorlink_tpu``, and none
needs ``safetensors``, ``transformers`` or ``huggingface_hub`` to import
(the card's machine has none of them; the loader reads safetensors files
itself and imports ``huggingface_hub`` only inside the hub download).

Three checks: every module imports in a fresh interpreter where those
packages are blocked in ``sys.modules`` (an import of any raises there),
no source line imports ``jax`` or ``tensorlink_tpu``, and the node's
network process (``nodes/roles.py::run_server`` with every module it
imports, at module level or inside a function) imports neither ``torch``
nor ``jax``, as the JAX package's keeps JAX out of it."""

import ast

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "tensorlink_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|tensorlink_tpu)(?:[.\s]|$)"
    r"|^\s*from\s+\.\.\.",  # nothing reaches above the package either
    re.M,
)

_PROBE = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "tensorlink_tpu", "safetensors", "transformers",
           "huggingface_hub")
for blocked in BLOCKED:
    sys.modules[blocked] = None  # any import of it now raises ImportError
import tensorlink_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401 — the chip script imports the port only
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
leaked = [m for m in leaked if sys.modules[m] is not None]
print(len(names), leaked)
print(" ".join(names))
"""

# the network process: roles.py plus everything its functions import, with
# torch blocked too (the ML side, not the network process, owns the card)
_NET_PROBE = """
import importlib, sys
BLOCKED = ("torch", "jax", "jaxlib", "tensorlink_tpu")
for blocked in BLOCKED:
    sys.modules[blocked] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
from tensorlink_tpu_torch.nodes.roles import run_server  # noqa: F401
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED
          and sys.modules[m] is not None]
print(sorted(leaked))
"""


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    first, walked = out.stdout.strip().splitlines()
    n, leaked = first.split(" ", 1)
    assert int(n) >= 66, out.stdout  # every module of the port was walked
    assert leaked == "[]", out.stdout
    for name in ("core.serialization", "core.faults", "engine.kvtier",
                 "fleet.prefixmap", "engine.loader", "engine.safetensors_io",
                 "parallel.expert", "core.config", "core.journal",
                 "core.ring", "core.shm", "crypto.identity", "p2p.node",
                 "p2p.tensor_node", "platform.keeper", "nodes.roles",
                 "nodes.runners", "parallel.planner", "ml.worker",
                 "ml.module", "ml.validator", "api.server", "native"):
        assert f"tensorlink_tpu_torch.{name}" in walked.split(), name


def test_no_source_line_imports_jax_or_the_jax_package():
    bad = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _sources()
        for m in FORBIDDEN.finditer(p.read_text())
    ]
    assert not bad, bad


def _imported_modules(path: pathlib.Path) -> set[str]:
    """Every package module ``path`` imports, at module level or inside a
    function (relative imports resolved against its package)."""
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
    return {m for m in out if m.startswith("tensorlink_tpu_torch")}


def test_network_process_imports_neither_torch_nor_jax():
    mods = _imported_modules(PKG / "nodes" / "roles.py")
    assert "tensorlink_tpu_torch.platform.keeper" in mods  # lazy imports seen
    assert "tensorlink_tpu_torch.p2p.upnp" in mods
    out = subprocess.run(
        [sys.executable, "-c", _NET_PROBE, *sorted(mods)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
