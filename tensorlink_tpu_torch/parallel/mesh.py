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
JAX's tiled ``all_gather`` computes; the GPipe schedule
(``parallel/pipeline.py``) and the ring (``parallel/ring.py``) loop over
their axis's devices the same way, moving activations with
:func:`to_device` where JAX's ``ppermute`` moves them.

A tensor placed on a mesh is a :class:`Sharded`: one tensor per device
of the mesh, in mesh order — its piece of the whole by a :class:`Split`
spec (a dimension per axis: one over ``tensor``/``tp``, one over
``data``, one over ``fsdp``, one over ``expert``, in any combination),
one tensor shared by
every shard on the same device that holds the same piece. The ``dim``
axis may be any axis of the mesh: ``Split(0, "stage")`` splits a stacked
layer leaf's leading dimension over the in-mesh pipeline stages (JAX's
``P("stage", ...)``), ``Split(1, "seq")`` an activation's sequence
dimension over the ring. :func:`put`
places a tree by a spec tree, as JAX's ``put`` does with
``NamedSharding``; :meth:`Sharded.full` joins a leaf exactly,
:func:`map_pieces` runs an elementwise function piece by piece and
:func:`take_rows` is the cross-shard row gather (the beam reorder over a
``data``-split cache).

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

    def axis_members(self, axis: str) -> list[int]:
        """The flattened devices along ``axis`` with every other axis at
        index 0, in axis order: the devices a loop over that axis runs
        on (the pipeline's stages, the ring's blocks)."""
        if axis not in self.axis_names:
            return [0]
        dim = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[dim]):
            idx = [0] * self.devices.ndim
            idx[dim] = i
            out.append(int(np.ravel_multi_index(idx, self.devices.shape)))
        return out

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


# axes a tree may be placed over
_PLACED_AXES = AXIS_ORDER


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class Split:
    """A spec leaf — JAX's ``PartitionSpec`` for the layouts the port
    places, a dimension per axis: dimension ``dim`` split over mesh axis
    ``axis`` (a tuple of axes splits it over their flattened grid,
    ``data_idx * tp + tp_idx``), dimension ``data_dim`` over ``data``,
    dimension ``fsdp_dim`` over ``fsdp`` and dimension ``expert_dim`` over
    ``expert`` (JAX's ``P(None, "fsdp", "tensor")`` is ``Split(2,
    "tensor", fsdp_dim=1)``, its ``P(None, "expert", "fsdp", "tensor")``
    ``Split(3, "tensor", fsdp_dim=2, expert_dim=1)``). A spec naming an
    axis the mesh lacks (or has at size 1) leaves that dimension whole.
    ``Split()`` replicates."""

    dim: int | None = None
    axis: str | tuple = "tp"
    data_dim: int | None = None
    fsdp_dim: int | None = None
    expert_dim: int | None = None

    def dims(self) -> tuple:
        """The dimensions each axis splits, in :func:`_grid`'s order:
        ``(dim, data_dim, fsdp_dim, expert_dim)``."""
        return (self.dim, self.data_dim, self.fsdp_dim, self.expert_dim)

    def parts(self, ndim: int) -> tuple:
        """The spec as JAX writes it: one entry per dimension — an axis
        name, a tuple of names, or None."""
        out: list = [None] * ndim
        if self.data_dim is not None:
            out[self.data_dim] = "data"
        if self.fsdp_dim is not None:
            out[self.fsdp_dim] = "fsdp"
        if self.expert_dim is not None:
            out[self.expert_dim] = "expert"
        if self.dim is not None:
            out[self.dim] = self.axis
        return tuple(out)


REPLICATED = Split()


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """THE cross-device copy of the sharded path: ``t`` itself when it
    lies on ``device``, else a copy there (between two cards a peer copy,
    ordered after the source's pending work by PyTorch; driven over four
    H100s by ``chip_smoke.tp_cards``)."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.device.type == device.type == "cuda")


def _check_axes(mesh: Mesh) -> None:
    for a, n in mesh.shape.items():
        if n > 1 and a not in _PLACED_AXES:
            raise ValueError(f"unknown mesh axis {a!r}")


def _grid(mesh: Mesh, spec: Split) -> tuple[int, int, int, int]:
    """How many pieces ``spec`` cuts along ``dim``, ``data_dim``,
    ``fsdp_dim`` and ``expert_dim`` on ``mesh``."""
    sizes = mesh.shape
    n_a = 1
    if spec.dim is not None:
        for a in _axes(spec.axis):
            n_a *= sizes.get(a, 1)
    n_d = sizes.get("data", 1) if spec.data_dim is not None else 1
    n_f = sizes.get("fsdp", 1) if spec.fsdp_dim is not None else 1
    n_e = sizes.get("expert", 1) if spec.expert_dim is not None else 1
    return n_a, n_d, n_f, n_e


_WHOLE = (1, 1, 1, 1)  # the grid of a leaf no axis cuts
_FIRST = (0, 0, 0, 0)  # the first piece's key


def _keys(mesh: Mesh, spec: Split) -> list[tuple[int, int, int, int]]:
    """Each flattened device's piece: its index along ``dim`` (over the
    flattened grid of the spec's axes), along ``data_dim``, along
    ``fsdp_dim`` and along ``expert_dim``."""
    n_a, n_d, n_f, n_e = _grid(mesh, spec)
    shape = mesh.devices.shape
    out = []
    for j in range(mesh.size):
        c = dict(zip(mesh.axis_names, np.unravel_index(j, shape)))
        a = 0
        for ax in _axes(spec.axis):
            a = a * mesh.shape.get(ax, 1) + int(c.get(ax, 0))
        out.append((a if n_a > 1 else 0,
                    int(c.get("data", 0)) if n_d > 1 else 0,
                    int(c.get("fsdp", 0)) if n_f > 1 else 0,
                    int(c.get("expert", 0)) if n_e > 1 else 0))
    return out


def _cuts(spec: Split, grid: tuple, key: tuple):
    """``(dim, pieces, index)`` of each dimension ``spec`` splits."""
    return [(d, n, i) for d, n, i in zip(spec.dims(), grid, key) if n > 1]


def _cut(x, spec: Split, grid: tuple, key: tuple, lead: int = 0):
    """Piece ``key`` of the whole array ``x`` (a view of a tensor or a
    numpy array); ``lead`` shifts the spec's dimensions (``-1``: ``x``
    lacks the leading layer axis)."""
    idx = [slice(None)] * len(x.shape)
    for dim, n, i in _cuts(spec, grid, key):
        if dim + lead < 0:  # the layer axis ``x`` lacks
            continue
        size = x.shape[dim + lead] // n
        idx[dim + lead] = slice(i * size, (i + 1) * size)
    return x[tuple(idx)]


def _check_split(shape, spec: Split, grid: tuple) -> None:
    dims = [d for d, n, _ in _cuts(spec, grid, _FIRST)]
    if len(set(dims)) < len(dims):
        raise ValueError(f"{spec} splits one dimension over two axes")
    for dim, n, _ in _cuts(spec, grid, _FIRST):
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways")


def _piece_shape(shape, spec: Split, grid: tuple) -> list:
    out = list(shape)
    for dim, n, _ in _cuts(spec, grid, _FIRST):
        out[dim] //= n
    return out


class Sharded:
    """One leaf placed on a mesh: ``shards[j]`` is flattened device
    ``j``'s tensor — its piece of the whole along ``spec.dim``,
    ``spec.data_dim``, ``spec.fsdp_dim`` and ``spec.expert_dim``
    (:func:`_keys`), one tensor
    shared by every shard on the same device that holds the same piece (a
    replicated leaf is the whole tensor). ``shape`` and ``dtype`` are the
    whole tensor's."""

    def __init__(self, shards: list, spec: Split, shape: tuple, mesh: Mesh):
        self.shards = list(shards)
        self.spec = spec
        self.shape = torch.Size(shape)
        self.mesh = mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def devices(self) -> list[torch.device]:
        return [t.device for t in self.shards]

    @property
    def grid(self) -> tuple[int, int]:
        """The pieces along ``spec.dim`` and along ``spec.data_dim``."""
        return _grid(self.mesh, self.spec)[:2]

    @property
    def n_fsdp(self) -> int:
        """The pieces along ``spec.fsdp_dim``."""
        return _grid(self.mesh, self.spec)[2]

    @property
    def n_expert(self) -> int:
        """The pieces along ``spec.expert_dim``."""
        return _grid(self.mesh, self.spec)[3]

    def pieces(self) -> int:
        """How many distinct pieces the spec cuts the whole into."""
        return int(np.prod(_grid(self.mesh, self.spec)))

    def keys(self) -> list[tuple[int, int, int, int]]:
        return _keys(self.mesh, self.spec)

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def distinct(self) -> list[int]:
        """The shards holding a tensor no earlier shard holds."""
        seen: set = set()
        out = []
        for j, t in enumerate(self.shards):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(j)
        return out

    def first_of_keys(self) -> dict:
        """Each piece's first shard in mesh order: ``{key: j}``."""
        first: dict = {}
        for j, key in enumerate(self.keys()):
            first.setdefault(key, j)
        return first

    def copy_(self, t: torch.Tensor, layer: int | None = None) -> None:
        """Copy the whole tensor ``t`` into this leaf's pieces, in place —
        into layer ``layer`` of each piece when ``t`` lacks the leading
        layer axis (the loader fills a stacked leaf layer by layer; a leaf
        split along its layers over ``stage`` takes the layer in the piece
        that holds it)."""
        grid, keys = _grid(self.mesh, self.spec), self.keys()
        lead = 0 if layer is None else -1
        for j in self.distinct():
            if layer is None:
                x = self.shards[j]
            else:
                per = self.shards[j].shape[0]
                at = [i for d, _, i in _cuts(self.spec, grid, keys[j])
                      if d == 0]
                if at and layer // per != at[0]:
                    continue
                x = self.shards[j][layer % per]
            x.copy_(_cut(t, self.spec, grid, keys[j], lead))

    def full(self, device=None, read=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the first shard's):
        the pieces concatenated in mesh order — exactly the tensor that
        was placed. ``read(j)`` reads flattened device ``j``'s piece
        (default ``shards[j]``; a train step's reader makes each piece a
        leaf of its own); a leaf no axis cuts reads the piece on
        ``device`` when there is one."""
        device = torch.device(device) if device is not None \
            else self.shards[0].device
        read = read or self.shards.__getitem__
        n_a, n_d, n_f, n_e = _grid(self.mesh, self.spec)
        if (n_a, n_d, n_f, n_e) == _WHOLE:
            on = [j for j, t in enumerate(self.shards) if t.device == device]
            return to_device(read(on[0] if on else 0), device)
        first = self.first_of_keys()
        sp = self.spec

        def cat(parts, dim):
            return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]

        return cat([cat([cat([cat([
            to_device(read(first[(a, d, f, e)]), device)
            for a in range(n_a)], sp.dim) for f in range(n_f)], sp.fsdp_dim)
            for e in range(n_e)], sp.expert_dim)
            for d in range(n_d)], sp.data_dim)

    def take_flat(self, idx) -> torch.Tensor:
        """The whole tensor's elements at the flat indices ``idx`` (a
        numpy int array), each read from the piece that holds it, on the
        first shard's device — a few coordinates without joining the
        whole."""
        idx = np.asarray(idx, dtype=np.int64)
        grid = _grid(self.mesh, self.spec)
        pshape = _piece_shape(self.shape, self.spec, grid)
        multi = np.unravel_index(idx, tuple(self.shape))
        key = [np.zeros(len(idx), np.int64) for _ in range(4)]
        local = [m.copy() for m in multi]
        for k, (dim, n) in enumerate(zip(self.spec.dims(), grid)):
            if n > 1:
                key[k] = multi[dim] // pshape[dim]
                local[dim] = multi[dim] % pshape[dim]
        flat_local = np.ravel_multi_index(tuple(local), tuple(pshape))
        dev0 = self.shards[0].device
        out = torch.empty(len(idx), dtype=self.dtype, device=dev0)
        first = self.first_of_keys()
        keys = list(zip(*(k.tolist() for k in key)))
        for kk in sorted(set(keys)):
            pos = [i for i, x in enumerate(keys) if x == kk]
            t = self.shards[first[kk]]
            at = torch.as_tensor(flat_local[pos], device=t.device)
            out[torch.as_tensor(pos, device=dev0)] = to_device(
                t.detach().reshape(-1)[at], dev0)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{[str(d) for d in self.devices]})")


def placed(mesh: Mesh, spec: Split, shape, make) -> Sharded:
    """A leaf of the whole ``shape`` laid out by ``spec``: ``make(key,
    device)`` builds piece ``key`` on ``device`` once per (device, key)."""
    _check_axes(mesh)
    _check_split(shape, spec, _grid(mesh, spec))
    made: dict = {}
    shards = []
    for dev, key in zip(mesh.flat(), _keys(mesh, spec)):
        if (dev, key) not in made:
            made[(dev, key)] = make(key, dev)
        shards.append(made[(dev, key)])
    return Sharded(shards, spec, shape, mesh)


def _place(mesh: Mesh, x: torch.Tensor, spec: Split | None) -> Sharded:
    spec = spec or REPLICATED
    grid = _grid(mesh, spec)
    if grid == _WHOLE:
        return placed(mesh, spec, x.shape, lambda _k, d: to_device(x, d))
    return placed(mesh, spec, x.shape, lambda k, d: _cut(
        x, spec, grid, k).to(d, copy=True).contiguous())


def put(mesh: Mesh, tree, specs):
    """Place a tree of tensors on ``mesh`` by a spec tree of the same
    structure (:class:`Split` leaves; None replicates): every leaf becomes
    a :class:`Sharded` whose pieces are contiguous copies on their devices
    (a replicated leaf already on a device is shared there, not copied).
    A tuple node (a ``KVCache`` field list, an optimizer state) places
    element by element."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(
                f"spec tree keys {sorted(specs) if isinstance(specs, dict) else specs} "
                f"do not match {sorted(tree)}"
            )
        return {k: put(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(put(mesh, v, s) for v, s in zip(tree, specs))
    if tree is None:
        return None
    if isinstance(tree, Sharded):
        return _relayout(tree, mesh, specs or REPLICATED)
    return _place(mesh, tree, specs)


def _relayout(x: Sharded, mesh: Mesh, spec: Split) -> Sharded:
    """A placed leaf laid out by ``spec`` on ``mesh``: as it is when
    nothing changes; on its own mesh cut finer (:func:`reslice`) or joined
    along one dimension (:func:`respec`) piece by piece; else joined whole
    and placed again."""
    if x.mesh is mesh and x.spec == spec:
        return x
    if x.mesh is mesh:
        keys, flat = _keys(mesh, spec), mesh.flat()
        made: dict = {}
        try:
            for j in range(mesh.size):
                if (flat[j], keys[j]) not in made:
                    made[(flat[j], keys[j])] = reslice(x, spec, j).clone()
            return from_pieces([made[(flat[j], keys[j])]
                                for j in range(mesh.size)],
                               spec, x.shape, mesh)
        except ValueError:
            pass
        try:
            return respec(x, spec)
        except ValueError:
            pass
    return _place(mesh, x.full(), spec)


def zeros(mesh: Mesh, shape, dtype, spec: Split) -> Sharded:
    """A zeroed tensor of the whole ``shape`` laid out by ``spec``, made
    piece by piece on each device (the whole is never built)."""
    shape = tuple(shape)
    grid = _grid(mesh, spec)
    _check_split(shape, spec, grid)
    piece = _piece_shape(shape, spec, grid)
    return placed(mesh, spec, shape, lambda _k, d: torch.zeros(
        piece, dtype=dtype, device=d))


def piece(x, spec: Split, mesh: Mesh, j: int):
    """Flattened device ``j``'s piece of the whole array ``x`` (a tensor,
    or a numpy array) under ``spec`` on ``mesh`` (a view)."""
    return _cut(x, spec, _grid(mesh, spec), _keys(mesh, spec)[j])


def from_pieces(pieces: list, spec: Split, shape, mesh: Mesh) -> Sharded:
    """The leaf whose flattened device ``j`` holds ``pieces[j]`` (each
    ``piece(whole, spec, mesh, j)``), one tensor kept per (device,
    piece)."""
    made: dict = {}
    shards = [made.setdefault((dev, key), t) for dev, key, t in zip(
        mesh.flat(), _keys(mesh, spec), pieces)]
    return Sharded(shards, spec, shape, mesh)


def take_rows(x: Sharded, idx, dim: int, spec: Split) -> Sharded:
    """THE cross-shard row gather: a leaf whose global row ``i`` along
    ``dim`` is ``x``'s global row ``idx[i]``, laid out by ``spec`` on
    ``x``'s mesh. A row of a ``data``-split source is read from the data
    shard that holds it (on another device it is copied from there), so
    a beam that follows a parent in another data shard reads the
    parent's row, bit for bit."""
    idx = [int(i) for i in (idx.tolist() if torch.is_tensor(idx) else idx)]
    mesh = x.mesh
    src_grid, src_keys = x.grid, x.keys()
    src_b = x.shape[dim] // src_grid[1]
    shape = list(x.shape)
    shape[dim] = len(idx)
    dst_grid = _grid(mesh, spec)
    if x.n_fsdp > 1 or x.n_expert > 1 or dst_grid[2:] != (1, 1):
        raise ValueError("take_rows gathers rows of a leaf not split over "
                         "fsdp or expert")
    if dst_grid[0] != src_grid[0] or (
            spec.dim if dst_grid[0] > 1 else None) != (
            x.spec.dim if src_grid[0] > 1 else None):
        raise ValueError(f"take_rows keeps the split along dim "
                         f"{x.spec.dim}: {spec} vs {x.spec}")
    dst_b = len(idx) // dst_grid[1]
    flat = mesh.flat()

    def source(a: int, d_src: int, dev) -> torch.Tensor:
        """The source piece (a, d_src), preferably one on ``dev``."""
        cands = [j for j, k in enumerate(src_keys) if k[:2] == (a, d_src)]
        on = [j for j in cands if flat[j] == dev]
        return x.shards[(on or cands)[0]]

    def make(key, dev):
        a, d = key[:2]
        rows = idx[d * dst_b:(d + 1) * dst_b] if dst_grid[1] > 1 else idx
        out = None
        for d_src in range(src_grid[1]):
            pos = [i for i, r in enumerate(rows)
                   if (r // src_b if src_grid[1] > 1 else 0) == d_src]
            if not pos:
                continue
            src = source(a, d_src, dev)
            local = torch.tensor([rows[i] - d_src * src_b
                                  if src_grid[1] > 1 else rows[i]
                                  for i in pos], device=src.device)
            got = to_device(src.index_select(dim, local), dev)
            if out is None:
                oshape = list(got.shape)
                oshape[dim] = len(rows)
                out = torch.empty(oshape, dtype=got.dtype, device=dev)
            out.index_copy_(dim, torch.tensor(pos, device=dev), got)
        return out

    return placed(mesh, spec, tuple(shape), make)


def map_pieces(fn, x: Sharded, *rest) -> Sharded:
    """An elementwise ``fn`` over a placed leaf: ``fn(piece, *others)``
    once per distinct piece of ``x``, where each of ``rest`` is a leaf
    placed like ``x`` (its piece there) or a tensor (a scalar: moved to
    the piece's device). The result is placed like ``x``."""
    out: dict = {}
    shards = []
    for j, t in enumerate(x.shards):
        if id(t) not in out:
            args = [r.shards[j] if isinstance(r, Sharded)
                    else to_device(r, t.device) for r in rest]
            out[id(t)] = fn(t, *args)
        shards.append(out[id(t)])
    return Sharded(shards, x.spec, x.shape, x.mesh)


def _region(shape, spec: Split, mesh: Mesh, j: int) -> list:
    """Device ``j``'s piece under ``spec`` as ``(start, stop)`` of the
    whole along each dimension."""
    grid = _grid(mesh, spec)
    out = [(0, n) for n in shape]
    for dim, n, i in _cuts(spec, grid, _keys(mesh, spec)[j]):
        size = shape[dim] // n
        out[dim] = (i * size, (i + 1) * size)
    return out


def reslice(x: Sharded, spec: Split, j: int) -> torch.Tensor:
    """Device ``j``'s piece of ``x`` under ``spec``, a layout that cuts
    ``x``'s pieces finer (ZeRO-1 splits a param's dim 0 over ``data`` as
    well): a view of ``x``'s piece there."""
    have = _region(x.shape, x.spec, x.mesh, j)
    want = _region(x.shape, spec, x.mesh, j)
    idx = []
    for (h0, h1), (w0, w1) in zip(have, want):
        if w0 < h0 or w1 > h1:
            raise ValueError(f"{spec} does not refine {x.spec}")
        idx.append(slice(w0 - h0, w1 - h0))
    return x.shards[j][tuple(idx)]


def respec(x: Sharded, spec: Split) -> Sharded:
    """``x`` laid out by ``spec``, a layout whose pieces join ``x``'s
    along one dimension (the inverse of :func:`reslice`): each piece is
    the fixed-order concatenation of ``x``'s pieces inside it — the
    all-gather that re-replicates a ZeRO-1 update over ``data``."""
    if spec == x.spec:
        return x
    mesh, shape = x.mesh, tuple(x.shape)
    fine = [_region(shape, x.spec, mesh, j) for j in range(mesh.size)]
    first = x.first_of_keys()
    keys = x.keys()

    def make(key, dev):
        j = _keys(mesh, spec).index(key)
        want = _region(shape, spec, mesh, j)
        inside = sorted({keys[i]: i for i in range(mesh.size)
                         if all(w0 <= f0 and f1 <= w1 for (f0, f1), (w0, w1)
                                in zip(fine[i], want))}.items())
        parts = [first[k] for k, _ in inside]
        dims = {d for d, ((a0, a1), (w0, w1)) in enumerate(
            zip(fine[parts[0]], want)) if (a0, a1) != (w0, w1)}
        if len(dims) > 1:
            raise ValueError(f"{x.spec} refines {spec} along {dims}")
        pieces = sorted(((fine[i][next(iter(dims))][0] if dims else 0, i)
                         for i in parts))
        ts = [to_device(x.shards[i], dev) for _, i in pieces]
        return torch.cat(ts, dim=next(iter(dims))) if len(ts) > 1 else ts[0]

    return placed(mesh, spec, shape, make)


def shard_tree(tree, j: int):
    """Shard ``j``'s view of a placed tree: the same structure with each
    :class:`Sharded` leaf replaced by its tensor there (a quantized leaf
    by its shard's codes and scales)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, j) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.shards[j]
    from ..models.quant import QTensor

    if isinstance(tree, QTensor) and isinstance(tree.q, Sharded):
        return QTensor(q=tree.q.shards[j], scale=tree.scale.shards[j])
    return tree


def is_sharded(tree) -> bool:
    """Whether a parameter tree's leaves are placed on a mesh."""
    while isinstance(tree, dict):
        if not tree:
            return False
        tree = next(iter(tree.values()))
    if isinstance(tree, Sharded):
        return True
    return isinstance(getattr(tree, "q", None), Sharded)


def full_tree(tree, device=None):
    """A placed tree joined whole on ``device`` (each leaf's
    :meth:`Sharded.full`); plain leaves pass through."""
    if isinstance(tree, dict):
        return {k: full_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(full_tree(v, device) for v in tree)
    if isinstance(tree, Sharded):
        return tree.full(device)
    return tree


def tree_mesh(tree) -> Mesh | None:
    """The mesh a placed tree lies on (its first leaf's)."""
    while isinstance(tree, dict):
        if not tree:
            return None
        tree = next(iter(tree.values()))
    if isinstance(tree, Sharded):
        return tree.mesh
    q = getattr(tree, "q", None)
    return q.mesh if isinstance(q, Sharded) else None


def shard_bytes(tree, j: int) -> int:
    """Bytes of the tensors flattened device ``j`` holds of the placed
    leaves of ``tree`` (dicts, tuples): one replica's share, which on
    distinct devices is that device's."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, j) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(shard_bytes(v, j) for v in tree)
    if isinstance(tree, Sharded):
        return tree.shards[j].numel() * tree.element_size()
    return 0


__all__ = [
    "AXIS_ORDER",
    "REPLICATED",
    "Mesh",
    "MeshPlan",
    "Sharded",
    "Split",
    "build_mesh",
    "from_pieces",
    "full_tree",
    "is_sharded",
    "local_devices",
    "local_mesh",
    "map_pieces",
    "piece",
    "placed",
    "put",
    "reslice",
    "respec",
    "serving_mesh",
    "shard_bytes",
    "shard_tree",
    "take_rows",
    "to_device",
    "tree_mesh",
    "zeros",
]
