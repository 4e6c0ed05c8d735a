"""The port stands alone: no module of tensorlink_tpu_torch (nor
chip_smoke.py) imports ``jax``, ``optax`` or anything of
``tensorlink_tpu``, and none
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
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|tensorlink_tpu)(?:[.\s]|$)"
    r"|^\s*from\s+\.\.\.",  # nothing reaches above the package either
    re.M,
)

_PROBE = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "optax", "tensorlink_tpu", "safetensors",
           "transformers", "huggingface_hub")
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
BLOCKED = ("torch", "jax", "jaxlib", "optax", "tensorlink_tpu")
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
    assert int(n) >= 77, out.stdout  # every module of the port was walked
    assert leaked == "[]", out.stdout
    for name in ("core.serialization", "core.faults", "engine.kvtier",
                 "fleet.prefixmap", "engine.loader", "engine.safetensors_io",
                 "parallel.expert", "core.config", "core.journal",
                 "core.ring", "core.shm", "crypto.identity", "p2p.node",
                 "p2p.tensor_node", "platform.keeper", "nodes.roles",
                 "nodes.runners", "parallel.planner", "ml.worker",
                 "ml.module", "ml.validator", "api.server", "native",
                 "engine.optimizers", "engine.training", "engine.serve_train",
                 "platform.proofs", "ml.optim", "fleet.router",
                 "fleet.autopilot", "cli", "utils.profiling",
                 "platform.chain", "parallel.mesh", "parallel.planner",
                 "parallel.multihost"):
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
    assert "tensorlink_tpu_torch.platform.proofs" in mods  # job_proofs
    assert "tensorlink_tpu_torch.platform.chain" in mods  # on-chain mode
    out = subprocess.run(
        [sys.executable, "-c", _NET_PROBE, *sorted(mods)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_unported_paths_name_a_queue_1_item():
    """Every ``unported(what, n)`` and every "ROADMAP queue 1 item n" in
    the port names an item that ROADMAP.md's queue 1 lists, so a refusal
    always points at the work that lifts it."""
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    items = {int(n) for n in re.findall(r"^(\d+)\. \*\*", queue, re.M)}
    assert items == set(range(1, len(items) + 1)), items
    cited = []
    for p in _sources():
        text = p.read_text()
        for m in re.finditer(r"unported\(\s*(?:\"[^\"]*\"\s*)+,\s*(\d+)\)"
                             r"|queue 1\s+item\s+(\d+)", text):
            cited.append((p.relative_to(REPO), int(m.group(1) or m.group(2))))
    assert cited
    stale = [c for c in cited if c[1] not in items]
    assert not stale, stale


def test_queue_1_items_1_and_2_left_no_refusal():
    """Pipelined training (queue 1 item 1) and the CLI, profiling and
    on-chain mode (item 2) are ported: no source of the port refuses with
    either item any more."""
    left = [
        f"{p.relative_to(REPO)}: {m.group(0)}"
        for p in _sources()
        for m in re.finditer(r"unported\(\s*(?:\"[^\"]*\"\s*)+,\s*[12]\)"
                             r"|queue 1\s+item\s+[12]\b", p.read_text())
    ]
    assert not left, left


def test_queue_1_item_3_refuses_only_gspmd_and_zero1():
    """Tensor-parallel serving, the GSPMD half, ZeRO-1 (PRs 13–14), the
    fsdp axis (item 3), the expert axis (item 4.1), the stage axis (item
    4.2), the co-slice coworkers over a process-spanning mesh (item 4.3)
    and ring attention with the quantized collectives (item 5) are
    ported: no source refuses with item 3, 4 or 5, no refusal names ring
    attention or the quantized gather, and the only refusals left name an
    axis or layer over a process-spanning mesh, citing item 6. Every axis
    of the mesh places, and queue 1's items still run from 1 without a
    gap."""
    from tensorlink_tpu_torch.parallel import mesh as tmesh
    from tensorlink_tpu_torch.parallel.mesh import _PLACED_AXES

    msgs = set()
    left = []
    for p in _sources():
        text = p.read_text()
        for m in re.finditer(r"unported\(\s*((?:\"[^\"]*\"\s*)+),\s*(\d)\)",
                             text):
            msg = "".join(re.findall(r'"([^"]*)"', m.group(1)))
            if m.group(2) in "345":
                left.append((p.relative_to(REPO).as_posix(), msg))
            msgs.add((p.relative_to(REPO).as_posix(), msg, int(m.group(2))))
    assert not left, left
    assert msgs
    for word in ("ring", "collective_quant", "coworkers"):
        assert not [m for m in msgs if word in m[1]], (word, msgs)
    assert sorted((path, item) for path, _, item in msgs) == [
        ("tensorlink_tpu_torch/engine/training.py", 6),
        ("tensorlink_tpu_torch/ml/worker.py", 6),
        ("tensorlink_tpu_torch/models/sharded.py", 6)], msgs
    assert all(what.endswith("over a process-spanning mesh")
               for _, what, _ in msgs), msgs
    assert not hasattr(tmesh, "_UNPORTED_AXES")
    assert set(_PLACED_AXES) >= {"stage", "data", "fsdp", "expert", "seq",
                                 "tensor", "tp"}
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    items = {int(n) for n in re.findall(r"^(\d+)\. \*\*", queue, re.M)}
    assert items == set(range(1, len(items) + 1)), items
    assert "fsdp" in queue and "expert" in queue


def test_queue_1_item_4_left_no_refusal():
    """The co-slice coworkers (queue 1 item 4.3, the last part of item 4)
    are ported: no source of the port refuses with item 4 any more, and
    ``parallel/multihost.py`` — the one file of the JAX package the port
    lacked — has its counterpart, so every module of the JAX package has
    one."""
    left = [
        f"{p.relative_to(REPO)}: {m.group(0)}"
        for p in _sources()
        for m in re.finditer(r"unported\(\s*(?:\"[^\"]*\"\s*)+,\s*4\)"
                             r"|queue 1\s+item\s+4\b", p.read_text())
    ]
    assert not left, left
    jax_pkg = REPO / "tensorlink_tpu"
    missing = sorted(
        p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")
        if "__pycache__" not in p.parts
        and not (PKG / p.relative_to(jax_pkg)).exists())
    assert not missing, missing
    assert (PKG / "parallel" / "multihost.py").exists()


def test_profiling_imports_torch_only():
    """``utils/profiling.py`` needs nothing beyond the standard library
    and ``torch``."""
    path = PKG / "utils" / "profiling.py"
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
    assert mods - {"torch", "__future__"} <= set(sys.stdlib_module_names), \
        mods
    assert "torch" in mods


def test_queue_1_items_9_and_10_left_no_refusal():
    """A shared page pool on a planned mesh (queue 1 item 9) and heads the
    tensor axis does not split in the placed slot engine (item 10) are
    ported: no source of the port cites either item any more."""
    left = [
        f"{p.relative_to(REPO)}: {m.group(0)}"
        for p in _sources()
        for m in re.finditer(r"unported\(\s*(?:\"[^\"]*\"\s*)+,\s*(?:9|10)\)"
                             r"|queue 1\s+items?\s+(?:9|10)\b",
                             p.read_text())
    ]
    assert not left, left
