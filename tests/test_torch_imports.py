"""The port stands alone: no module of tensorlink_tpu_torch (nor
chip_smoke.py) imports ``jax`` or anything of ``tensorlink_tpu``.

Two checks: every module imports in a fresh interpreter where ``jax`` and
``tensorlink_tpu`` are blocked in ``sys.modules`` (an import of either
raises there), and no source line imports them."""

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
for blocked in ("jax", "jaxlib", "tensorlink_tpu"):
    sys.modules[blocked] = None  # any import of it now raises ImportError
import tensorlink_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401 — the chip script imports the port only
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                or m == "tensorlink_tpu" or m.startswith("tensorlink_tpu."))
leaked = [m for m in leaked if sys.modules[m] is not None]
print(len(names), leaked)
print(" ".join(names))
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
    assert int(n) >= 28, out.stdout  # every module of the port was walked
    assert leaked == "[]", out.stdout
    for name in ("core.serialization", "core.faults", "engine.kvtier",
                 "fleet.prefixmap"):
        assert f"tensorlink_tpu_torch.{name}" in walked.split(), name


def test_no_source_line_imports_jax_or_the_jax_package():
    bad = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _sources()
        for m in FORBIDDEN.finditer(p.read_text())
    ]
    assert not bad, bad
