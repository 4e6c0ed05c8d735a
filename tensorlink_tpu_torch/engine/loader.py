"""HF safetensors checkpoint ⇄ stacked parameter tree (port of
``tensorlink_tpu/engine/loader.py``).

:func:`load_params` reads each tensor from its shard file
(``engine/safetensors_io.py``: a mapped file, no ``safetensors``
package), applies the family's name-map rule (``~T`` transposes from
torch's ``[out, in]``, GPT-2's ``split3``, Phi-3's ``rowsT`` slices,
GPT-NeoX's per-head ``neox_qkv(b)``, Mixtral's per-expert ``stackE``)
and copies it into its layer's slot of the ``[L, …]`` leaf on the
device, one tensor at a time: the raw tensor moves to the device first
and the rule's views and the dtype cast run there, so no whole leaf is
ever stacked on the host. ``layer_range`` restricts the reads (and, for
a hub repo id, the download) to a pipeline stage's slice.

:func:`export_hf` is the inverse and writes the files the JAX
``export_hf`` writes for the same parameters, byte for byte: each shard,
the index JSON and ``config.json``.

The hub branch of :func:`_hub_fetch` imports ``huggingface_hub`` only
when it runs; ``TLTPU_HUB_SOURCE`` serves a local mirror instead.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any

import torch

from ..core.devices import resolve_device
from ..models.base import ModelConfig
from ..models.quant import QTensor
from ..models.registry import config_from_hf, hf_name_map, hf_prefix
from ..parallel.mesh import REPLICATED, Sharded
from ..parallel.mesh import zeros as mesh_zeros
from .safetensors_io import SafetensorsFile, save_file

# ---------------------------------------------------------------------------
# HF Hub acquisition: a stage fetches only the shards covering its layers
# ---------------------------------------------------------------------------

_REPO_ID_RE = re.compile(r"[\w.\-]+/[\w.\-]+")
_LAYER_RE = re.compile(r"(?:^|\.)(?:layers|h|blocks)\.(\d+)\.")
_TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "vocab.json",
    "merges.txt",
    "special_tokens_map.json",
    "generation_config.json",
)


def _cache_root() -> Path:
    return Path(
        os.environ.get("TLTPU_CACHE", "~/.cache/tensorlink_tpu")
    ).expanduser()


def _absent_marker(dest: Path) -> Path:
    return dest / ".absent.json"


def _known_absent(dest: Path, filename: str) -> bool:
    marker = _absent_marker(dest)
    if not marker.exists():
        return False
    try:
        return filename in json.loads(marker.read_text())
    except (OSError, ValueError):
        return False


def _record_absent(dest: Path, filename: str) -> None:
    marker = _absent_marker(dest)
    try:
        absent = json.loads(marker.read_text()) if marker.exists() else []
    except (OSError, ValueError):
        absent = []
    if filename not in absent:
        absent.append(filename)
        marker.write_text(json.dumps(absent))


def _hub_fetch(
    repo_id: str, filename: str, dest: Path, *, required: bool = True
) -> Path | None:
    """Materialize one repo file into ``dest``.

    ``TLTPU_HUB_SOURCE=<dir>`` serves files from ``<dir>/<repo_id>/``
    instead of the network (the offline path; env-based so it reaches
    spawned worker processes). Otherwise ``huggingface_hub`` downloads.

    Files land atomically (temp name + ``os.replace``). A file the repo
    lacks is recorded in ``.absent.json`` so optional probes are not
    repeated; a transient fetch error raises even for optional files."""
    target = dest / filename
    if target.exists():
        return target
    if _known_absent(dest, filename):
        if required:
            raise FileNotFoundError(
                f"{repo_id}/{filename} does not exist in the repo")
        return None
    dest.mkdir(parents=True, exist_ok=True)
    src_root = os.environ.get("TLTPU_HUB_SOURCE")
    if src_root:
        src = Path(src_root) / repo_id / filename
        if src.exists():
            tmp = target.with_name(target.name + ".tmp-fetch")
            shutil.copy2(src, tmp)
            os.replace(tmp, target)
            return target
        _record_absent(dest, filename)
        if required:
            raise FileNotFoundError(
                f"{repo_id}/{filename} not in hub source {src_root}")
        return None
    from huggingface_hub import hf_hub_download
    from huggingface_hub.utils import EntryNotFoundError

    try:
        # hf_hub_download writes via its own temp file + rename (atomic)
        hf_hub_download(repo_id, filename, local_dir=str(dest))
        return target
    except EntryNotFoundError as e:
        _record_absent(dest, filename)
        if required:
            raise FileNotFoundError(
                f"{repo_id}/{filename} does not exist in the repo"
            ) from e
        return None


def resolve_checkpoint(
    ref: str | Path,
    *,
    layer_range: tuple[int, int] | None = None,
    config_only: bool = False,
    cache_dir: str | Path | None = None,
) -> Path:
    """Turn a checkpoint reference into a local directory.

    - an existing local path is returned as-is;
    - an ``org/name`` repo id is materialized under the cache:
      ``config.json``, the safetensors index and, unless ``config_only``,
      only the weight shards holding tensors of ``layer_range`` (plus the
      non-layer tensors), and the tokenizer files.
    """
    p = Path(ref)
    if p.exists():
        return p
    ref = str(ref)
    if not _REPO_ID_RE.fullmatch(ref) or any(
        set(seg) == {"."} for seg in ref.split("/")
    ):
        # the dot-segment check stops a network-supplied ref like "../.."
        # from escaping TLTPU_HUB_SOURCE via the path join
        raise FileNotFoundError(
            f"checkpoint {ref!r} is neither a local directory nor an "
            "org/name repo id"
        )
    dest = (
        Path(cache_dir)
        if cache_dir
        else _cache_root() / "hub" / ref.replace("/", "--")
    )
    _hub_fetch(ref, "config.json", dest)
    if config_only:
        return dest
    index = _hub_fetch(
        ref, "model.safetensors.index.json", dest, required=False
    )
    if index is None:
        _hub_fetch(ref, "model.safetensors", dest)
    else:
        weight_map: dict[str, str] = json.loads(index.read_text())[
            "weight_map"]
        needed: set[str] = set()
        for name, fname in weight_map.items():
            m = _LAYER_RE.search(name)
            if (
                layer_range is None
                or m is None
                or layer_range[0] <= int(m.group(1)) < layer_range[1]
            ):
                needed.add(fname)
        for fname in sorted(needed):
            _hub_fetch(ref, fname, dest)
    for fname in _TOKENIZER_FILES:
        _hub_fetch(ref, fname, dest, required=False)
    return dest


class CheckpointReader:
    """Random access over a (possibly sharded) safetensors checkpoint
    directory; :meth:`get` returns a CPU tensor viewing the mapped
    file."""

    def __init__(self, ckpt_dir: str | Path):
        self.dir = Path(ckpt_dir)
        index_path = self.dir / "model.safetensors.index.json"
        self._name_to_file: dict[str, str] = {}
        self._handles: dict[str, SafetensorsFile] = {}
        if index_path.exists():
            index = json.loads(index_path.read_text())
            self._name_to_file = dict(index["weight_map"])
        else:
            files = sorted(self.dir.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no safetensors files in {self.dir}")
            for fp in files:
                for name in self._file(fp.name).keys():
                    self._name_to_file[name] = fp.name

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._handles:
            self._handles[fname] = SafetensorsFile(self.dir / fname)
        return self._handles[fname]

    def names(self) -> list[str]:
        return list(self._name_to_file)

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file

    def get(self, name: str) -> torch.Tensor:
        return self._file(self._name_to_file[name]).get(name)

    def config(self) -> dict:
        return json.loads((self.dir / "config.json").read_text())


def _tensor_name(template: str, prefix: str, **fmt) -> tuple[bool, tuple]:
    """``(transpose, candidates)`` of a name template: the ``~T`` marker,
    and the names to try in order (``^`` marks a top-level tensor; HF
    checkpoints differ on whether the backbone prefix is present)."""
    transpose = template.startswith("~T ")
    name = template[3:] if transpose else template
    top_level = name.startswith("^")
    name = (name[1:] if top_level else name).format(**fmt)
    return transpose, ((name, prefix + name) if top_level
                       else (prefix + name, name))


def _resolve(reader: CheckpointReader, template: str, prefix: str,
             device, **fmt) -> torch.Tensor:
    """One tensor on ``device`` in the tree's layout (``~T`` applied as a
    view)."""
    transpose, candidates = _tensor_name(template, prefix, **fmt)
    for candidate in candidates:
        if candidate in reader:
            t = reader.get(candidate).to(device)
            return t.T if transpose else t
    raise KeyError(f"tensor {candidates[0]!r} not in checkpoint")


def _fetch(reader, template, prefix, cfg, device, **fmt) -> torch.Tensor:
    """One layer's (or a top-level) leaf slice on ``device``, through the
    name map's rule; a view of the checkpoint tensor wherever it can be."""
    if not isinstance(template, tuple):
        return _resolve(reader, template, prefix, device, **fmt)
    rule, tmpl = template
    if rule == "stackE":
        return torch.stack([
            _resolve(reader, tmpl, prefix, device, e=e, **fmt)
            for e in range(cfg.n_experts)
        ])
    full = _resolve(reader, tmpl, prefix, device, **fmt)
    hd = cfg.head_dim
    if rule.startswith("split3"):  # GPT-2 Conv1D fused qkv, [in, 3·out]
        return torch.chunk(full, 3, dim=-1)[int(rule.split(".")[1])]
    if rule.startswith("rowsT"):
        # fused [rows, d] torch weight (Phi-3 qkv_proj / gate_up_proj): a
        # row slice, then the transpose
        _, lo, hi = rule.split(".")
        return full[int(lo):int(hi)].T
    if rule.startswith("neox_qkvb"):
        # GPT-NeoX fused qkv bias [3d] with per-head interleaving
        return full.reshape(-1, 3, hd)[:, int(rule.split(".")[1])].reshape(-1)
    if rule.startswith("neox_qkv"):
        # GPT-NeoX fused qkv weight [3d, d], rows per head as (q | k | v)
        d_in = full.shape[-1]
        part = full.reshape(-1, 3, hd, d_in)[:, int(rule.split(".")[1])]
        return part.reshape(-1, d_in).T
    raise ValueError(f"unknown fetch rule {rule}")


def load_params(
    ckpt_dir: str | Path,
    cfg: ModelConfig | None = None,
    *,
    layer_range: tuple[int, int] | None = None,
    device=None,
    dtype: torch.dtype | None = None,
    mesh=None,
    specs: dict | None = None,
    tensor_parallel: int = 0,
    tp_devices: list | None = None,
) -> tuple[ModelConfig, dict]:
    """Load a checkpoint into the stacked parameter tree on ``device``
    (None = the CUDA card). Returns ``(cfg, params)``: ``cfg`` from the
    checkpoint's ``config.json`` when not given, its dtype set to
    ``dtype`` (default ``cfg.dtype``), which every float leaf is cast to
    (round to nearest even, as the JAX loader's numpy cast).

    ``layer_range=(lo, hi)`` loads only layers ``lo..hi-1`` (a pipeline
    stage's slice); reads, and for a hub repo id the download, are
    restricted to those tensors.

    ``mesh`` with a ``specs`` tree (``parallel/mesh.py::Split`` leaves)
    places every tensor straight onto its shards as it leaves the
    checkpoint (through host memory, one tensor at a time), so the whole
    tree never sits on one device; every leaf is then a ``Sharded``.
    ``tensor_parallel=N`` (N > 1) is the serving-path form: the mesh is
    ``serving_mesh(N, devices=tp_devices)`` (the local cards unless
    named) and the specs ``tp_partition_specs``, and the result is what
    ``ContinuousEngine(tensor_parallel=N)`` takes without another copy.
    It excludes an explicit ``mesh``/``specs`` pair."""
    reader = CheckpointReader(
        resolve_checkpoint(ckpt_dir, layer_range=layer_range)
    )
    if cfg is None:
        cfg = config_from_hf(reader.config())
    dt = dtype or cfg.dtype
    cfg = cfg.with_(dtype=dt)  # activations follow the loaded param dtype
    if tensor_parallel and int(tensor_parallel) > 1:
        if mesh is not None or specs is not None:
            raise ValueError(
                "tensor_parallel composes its own mesh/specs — pass one "
                "or the other, not both"
            )
        from ..models.transformer import tp_partition_specs, tp_shardable
        from ..parallel.mesh import serving_mesh

        tp = int(tensor_parallel)
        reason = tp_shardable(cfg, tp)
        if reason is not None:
            raise ValueError(f"tensor_parallel={tp}: {reason}")
        mesh = serving_mesh(tp, devices=tp_devices)
        specs = tp_partition_specs(cfg)
    if (mesh is None) != (specs is None):
        raise ValueError("mesh and specs go together")
    # placed leaves pass through the host one tensor at a time
    dev = torch.device("cpu") if mesh is not None else resolve_device(device)
    prefix = hf_prefix(cfg)
    lo, hi = layer_range or (0, cfg.n_layers)
    if hi <= lo:
        raise ValueError(f"empty layer_range {layer_range}")

    def fetch(template, **fmt):
        return _fetch(reader, template, prefix, cfg, dev, **fmt)

    def spec_of(path):
        node = specs
        for p in path.split("."):
            node = node[p]
        return node or REPLICATED

    params: dict[str, Any] = {"embed": {}, "layers": {}, "final_norm": {}}
    for path, template in hf_name_map(cfg).items():
        parts = path.split(".")
        if parts[0] == "layers":
            leaf = None
            for j, i in enumerate(range(lo, hi)):
                t = fetch(template, i=i)
                if leaf is None:
                    shape = (hi - lo, *t.shape)
                    leaf = (torch.empty(shape, dtype=dt, device=dev)
                            if mesh is None
                            else mesh_zeros(mesh, shape, dt,
                                             spec_of(path)))
                elif t.shape != leaf.shape[1:]:
                    raise ValueError(f"{path}: layer {i} has shape "
                                     f"{tuple(t.shape)}, layer {lo} "
                                     f"{tuple(leaf.shape[1:])}")
                _fill(leaf, j, t)
            node = params["layers"].setdefault(parts[1], {})
            if len(parts) != 3:  # layers.<p> (no leaf name) does not occur
                raise AssertionError(path)
            node[parts[2]] = leaf
        else:
            node = params
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            t = fetch(template)
            if mesh is None:
                node[parts[-1]] = torch.empty(t.shape, dtype=dt,
                                              device=dev).copy_(t)
            else:
                leaf = mesh_zeros(mesh, tuple(t.shape), dt, spec_of(path))
                _fill(leaf, None, t)
                node[parts[-1]] = leaf
    return cfg, params


def _fill(leaf, j: int | None, t: torch.Tensor) -> None:
    """Copy host tensor ``t`` into layer ``j`` of ``leaf`` (the whole
    leaf when ``j`` is None), cast to its dtype; a ``Sharded`` leaf takes
    each shard's piece."""
    if isinstance(leaf, Sharded):
        leaf.copy_(t, j)
    else:
        (leaf if j is None else leaf[j]).copy_(t)


def export_hf(
    cfg: ModelConfig,
    params: dict,
    out_dir: str | Path,
    *,
    hf_config: dict | None = None,
    max_shard_bytes: int = 4 * 1024**3,
) -> Path:
    """Write ``params`` (a float tree on any device) back out as an
    HF-layout safetensors checkpoint: the files the JAX ``export_hf``
    writes for the same parameters, byte for byte. Each tensor reaches the
    host only when its shard is written."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prefix = hf_prefix(cfg)

    # name -> tensor (views where possible), in the JAX exporter's
    # insertion order, which decides the shard split
    tensors: dict[str, torch.Tensor] = {}
    fused: dict[str, list] = {}  # gpt2 split3 (concat on last axis)
    fused_rows: dict[str, list] = {}  # phi3 rowsT (row-slice reassembly)
    fused_qkv: dict[str, list] = {}  # gpt_neox interleaved qkv weight
    fused_qkvb: dict[str, list] = {}  # gpt_neox interleaved qkv bias

    def emit(template, a, **fmt):
        # the first candidate is the exported name (prefixed unless "^")
        transpose, (full, _) = _tensor_name(template, prefix, **fmt)
        tensors[full] = a.T if transpose else a

    for path, template in hf_name_map(cfg).items():
        node = params
        for p in path.split("."):
            node = node[p]
        if isinstance(node, QTensor):
            raise TypeError(f"{path} is quantized: export a float tree")
        if path.split(".")[0] != "layers":
            if isinstance(template, tuple):
                raise AssertionError(path)
            emit(template, node)
            continue
        for i in range(node.shape[0]):
            a = node[i]
            if not isinstance(template, tuple):
                emit(template, a, i=i)
                continue
            rule, tmpl = template
            if rule == "stackE":
                for e in range(a.shape[0]):
                    emit(tmpl, a[e], i=i, e=e)
                continue
            key = tmpl.format(i=i)
            if rule.startswith("rowsT"):
                _, lo, hi = rule.split(".")
                fused_rows.setdefault(key, []).append((int(lo), int(hi), a.T))
                continue
            part = int(rule.split(".")[1])
            if rule.startswith("split3"):
                fused.setdefault(key, [None] * 3)[part] = a
            elif rule.startswith("neox_qkvb"):
                fused_qkvb.setdefault(key, [None] * 3)[part] = a
            elif rule.startswith("neox_qkv"):
                fused_qkv.setdefault(key, [None] * 3)[part] = a.T
            else:
                raise AssertionError(f"unknown export rule {rule}")
    for name, chunks in fused.items():
        tensors[prefix + name] = torch.cat(chunks, dim=-1)
    for name, pieces in fused_rows.items():
        rows = max(hi for _, hi, _ in pieces)
        first = pieces[0][2]
        buf = first.new_zeros((rows, first.shape[1]))
        for lo, hi, a in pieces:
            buf[lo:hi] = a
        tensors[prefix + name] = buf
    hd = cfg.head_dim
    for name, parts3 in fused_qkv.items():
        stacked = torch.stack(
            [p.reshape(-1, hd, p.shape[-1]) for p in parts3], dim=1
        )  # [H, 3, hd, d]
        tensors[prefix + name] = stacked.reshape(-1, stacked.shape[-1])
    for name, parts3 in fused_qkvb.items():
        stacked = torch.stack([p.reshape(-1, hd) for p in parts3], dim=1)
        tensors[prefix + name] = stacked.reshape(-1)

    _write_sharded(tensors, out, max_shard_bytes)
    if hf_config is not None:
        (out / "config.json").write_text(json.dumps(hf_config, indent=2))
    return out


def _write_sharded(
    tensors: dict[str, torch.Tensor], out: Path, max_shard_bytes: int
) -> None:
    """Write safetensors honoring ``max_shard_bytes``: one
    ``model.safetensors`` when everything fits, else HF-convention
    ``model-NNNNN-of-NNNNN.safetensors`` shards (filled in insertion
    order) plus ``model.safetensors.index.json``."""
    total = sum(t.nbytes for t in tensors.values())
    if total <= max_shard_bytes:
        save_file(tensors, out / "model.safetensors")
        return
    shards: list[dict[str, torch.Tensor]] = [{}]
    cur_bytes = 0
    for name, t in tensors.items():
        if shards[-1] and cur_bytes + t.nbytes > max_shard_bytes:
            shards.append({})
            cur_bytes = 0
        shards[-1][name] = t
        cur_bytes += t.nbytes
    n = len(shards)
    weight_map: dict[str, str] = {}
    for i, shard in enumerate(shards, 1):
        fname = f"model-{i:05d}-of-{n:05d}.safetensors"
        save_file(shard, out / fname)
        for name in shard:
            weight_map[name] = fname
    (out / "model.safetensors.index.json").write_text(
        json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map},
            indent=2,
        )
    )


def estimate_params_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return cfg.param_count() * dtype_bytes


__all__ = ["CheckpointReader", "estimate_params_bytes", "export_hf",
           "load_params", "resolve_checkpoint"]
