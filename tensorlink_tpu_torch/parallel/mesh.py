"""Device meshes and tensors placed on them (port of
``tensorlink_tpu/parallel/mesh.py``).

Axis convention, as in the JAX package (outermost first):

- ``stage``   — pipeline stages
- ``data``    — batch sharding (DP)
- ``fsdp``    — parameter/optimizer sharding (ZeRO-3)
- ``expert``  — MoE expert parallelism
- ``seq``     — sequence/context parallelism (ring attention)
- ``tensor``  — megatron TP inside a layer (the GSPMD dense path)
- ``tp``      — explicit tensor parallelism for the paged serving path

A :class:`Mesh` is the axis names plus a numpy array of ``torch.device``s
shaped by the axis sizes, ``tp`` innermost. The port is single-controller
as the JAX package is: one Python process drives every device of the
mesh. JAX's ``shard_map`` (and with it ``get_shard_map`` and
``mark_varying``) has no counterpart here: the serving step
(``engine/paged.py::make_tp_ragged_step``) writes its loop over the
shards itself and reassembles each split activation with a fixed-order
concatenation (``models/transformer.py::_tp_gather``), which is what
JAX's tiled ``all_gather`` computes.

A tensor placed on a mesh is a :class:`Sharded`: one tensor per device of
a ``(1, tp)`` mesh, in mesh order, shard ``j`` the ``j``-th piece along
the split dimension (a :class:`Split` spec), or the whole tensor for a
replicated leaf, shared by every shard on the same device. :func:`put`
places a tree by a spec tree, as JAX's ``put`` does with
``NamedSharding``. ``serving_mesh`` lays out a data axis as JAX's does,
but placement on it (data-parallel serving) is not ported and raises.

The default devices are the distinct local CUDA cards. A device repeats
in a mesh only when the caller names the devices: the tests lay N shards
on the CPU (``[cpu] * N``), as the JAX package's tests lay them on
virtual host devices, and one card can hold both shards of a tp=2 mesh
(``[cuda:0, cuda:0]``) to run the sharded path where one card is all
there is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

AXIS_ORDER = ("stage", "data", "fsdp", "expert", "seq", "tensor", "tp")


@dataclass(frozen=True)
class MeshPlan:
    """Resolved axis sizes for one node's mesh."""

    axis_sizes: dict[str, int] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= s
        return n

    def names(self) -> tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if self.axis_sizes.get(a, 1) > 1) or (
            "data",
        )


class Mesh:
    """Axis names plus an array of ``torch.device``s shaped by the axis
    sizes (outer → inner)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims named {axis_names}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices in flattened (row-major) mesh order."""
        return list(self.devices.reshape(-1))

    def axis_index(self, axis: str) -> list[int]:
        """Each flattened device's index along ``axis`` (0 everywhere for
        an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return [0] * self.size
        dim = self.axis_names.index(axis)
        return [int(np.unravel_index(j, self.devices.shape)[dim])
                for j in range(self.size)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def local_devices() -> list[torch.device]:
    """The distinct local CUDA cards, in index order (none without a
    card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so one card
    is one device of the mesh however it was named."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def build_mesh(
    axis_sizes: dict[str, int],
    devices: list | None = None,
) -> Mesh:
    """Build a Mesh with axes ordered outer→inner so ``tensor``/``tp``
    land innermost. Axes of size 1 are kept. ``devices`` defaults to the
    distinct local cards; a device may repeat only in a list the caller
    gives."""
    devices = (
        local_devices() if devices is None
        else [_indexed(torch.device(d)) for d in devices]
    )
    names = [a for a in AXIS_ORDER if a in axis_sizes]
    extra = [a for a in axis_sizes if a not in AXIS_ORDER]
    names += extra
    sizes = [int(axis_sizes[a]) for a in names]
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = d
    return Mesh(arr.reshape(sizes), tuple(names))


def local_mesh(**axis_sizes: int) -> Mesh:
    """A mesh over all local cards; one axis may be -1."""
    devs = local_devices()
    sizes = dict(axis_sizes) if axis_sizes else {"data": -1}
    wild = [a for a, s in sizes.items() if s == -1]
    if wild:
        known = int(np.prod([s for s in sizes.values() if s != -1]))
        sizes[wild[0]] = len(devs) // known
    return build_mesh(sizes, devs)


def serving_mesh(
    tp: int, dp: int = 1, devices: list | None = None
) -> Mesh:
    """The ``(dp, tp)`` mesh the paged serving path runs on: ``tp``
    innermost, so the flattened device index is ``data_idx * tp +
    tp_idx``."""
    return build_mesh({"data": int(dp), "tp": int(tp)}, devices)


@dataclass(frozen=True)
class Split:
    """A spec leaf: split dimension ``dim`` over mesh axis ``axis``, or
    replicate (``dim=None``) — JAX's ``PartitionSpec`` with at most one
    named dimension."""

    dim: int | None = None
    axis: str = "tp"


REPLICATED = Split()


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """THE cross-device copy of the sharded path: ``t`` itself when it
    lies on ``device``, else a copy there (between two cards a peer copy,
    ordered after the source's pending work by PyTorch; driven over four
    H100s by ``chip_smoke.tp_cards``)."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.device.type == device.type == "cuda")


class Sharded:
    """One leaf placed on a ``(1, tp)`` mesh: ``shards[j]`` is shard
    ``j``'s tensor on flattened device ``j`` — its piece ``j`` along
    ``spec.dim``, or the whole tensor when ``spec.dim`` is None, one
    tensor shared by every shard on the same device. ``shape`` and
    ``dtype`` are the whole tensor's."""

    def __init__(self, shards: list, spec: Split, shape: tuple):
        self.shards = list(shards)
        self.spec = spec
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def devices(self) -> list[torch.device]:
        return [t.device for t in self.shards]

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the first shard's):
        the pieces concatenated in mesh order."""
        device = torch.device(device) if device is not None \
            else self.shards[0].device
        if self.spec.dim is None:
            return to_device(self.shards[0], device)
        return torch.cat([to_device(p, device) for p in self.shards],
                         dim=self.spec.dim)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, dim="
                f"{self.spec.dim}, {[str(d) for d in self.devices]})")


def _per_device(devs: list, make) -> list:
    """``make(d)`` once per distinct device, listed in mesh order (the
    shards on one device share it)."""
    made: dict = {}
    for d in devs:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in devs]


def _tp_devices(mesh: Mesh) -> list[torch.device]:
    """The devices of a ``(1, tp)`` mesh in shard order; data-parallel
    placement is not ported, so any other axis above 1 raises."""
    wide = {a: n for a, n in mesh.shape.items() if a != "tp" and n > 1}
    if wide:
        raise ValueError(
            f"a tree is placed on a (1, tp) mesh only; this mesh has {wide}"
        )
    return mesh.flat()


def _place(mesh: Mesh, x: torch.Tensor, spec: Split | None) -> Sharded:
    spec = spec or REPLICATED
    devs = _tp_devices(mesh)
    if spec.dim is None:
        shards = _per_device(devs, lambda d: to_device(x, d))
    else:
        if x.shape[spec.dim] % len(devs):
            raise ValueError(f"dim {spec.dim} of {tuple(x.shape)} does not "
                             f"split {len(devs)} ways")
        pieces = torch.chunk(x, len(devs), dim=spec.dim)
        shards = [p.to(d, copy=True).contiguous()
                  for p, d in zip(pieces, devs)]
    return Sharded(shards, spec, x.shape)


def put(mesh: Mesh, tree, specs):
    """Place a tree of tensors on ``mesh`` by a spec tree of the same
    structure (:class:`Split` leaves; None replicates): every leaf becomes
    a :class:`Sharded` whose pieces are contiguous copies on their devices
    (a replicated leaf already on a device is shared there, not copied).
    ``mesh`` has no axis but ``tp`` above 1."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(
                f"spec tree keys {sorted(specs) if isinstance(specs, dict) else specs} "
                f"do not match {sorted(tree)}"
            )
        return {k: put(mesh, v, specs[k]) for k, v in tree.items()}
    return _place(mesh, tree, specs)


def zeros(mesh: Mesh, shape, dtype, spec: Split) -> Sharded:
    """A zeroed tensor of the whole ``shape`` laid out by ``spec``, made
    piece by piece on each device (the whole is never built)."""
    shape = tuple(shape)
    devs = _tp_devices(mesh)
    if spec.dim is None:
        shards = _per_device(
            devs, lambda d: torch.zeros(shape, dtype=dtype, device=d))
    else:
        if shape[spec.dim] % len(devs):
            raise ValueError(f"dim {spec.dim} of {shape} does not split "
                             f"{len(devs)} ways")
        piece = list(shape)
        piece[spec.dim] //= len(devs)
        shards = [torch.zeros(piece, dtype=dtype, device=d) for d in devs]
    return Sharded(shards, spec, shape)


def shard_tree(tree, j: int):
    """Shard ``j``'s view of a placed tree: the same structure
    with each :class:`Sharded` leaf replaced by its tensor there."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, j) for k, v in tree.items()}
    return tree.shards[j]


def is_sharded(tree) -> bool:
    """Whether a parameter tree's leaves are placed on a mesh."""
    while isinstance(tree, dict):
        if not tree:
            return False
        tree = next(iter(tree.values()))
    return isinstance(tree, Sharded)


__all__ = [
    "AXIS_ORDER",
    "REPLICATED",
    "Mesh",
    "MeshPlan",
    "Sharded",
    "Split",
    "build_mesh",
    "is_sharded",
    "local_devices",
    "local_mesh",
    "put",
    "serving_mesh",
    "shard_tree",
    "to_device",
    "zeros",
]
