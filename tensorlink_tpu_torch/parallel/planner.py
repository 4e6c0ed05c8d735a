"""Sharding planner (port of ``tensorlink_tpu/parallel/planner.py``).

The validator plans a job over the live worker capacities: the HBM memory
model (params + grads + optimizer state + activations + KV cache, x1.1),
the per-worker mesh axes, single-worker fit first and else contiguous
pipeline stages, tied embeddings pinned to stage 0. The emitted
:class:`ShardingPlan` is JSON and byte-compatible with the JAX planner's,
so either package's worker reads it.

The PartitionSpec builders (``stage_param_specs``/``stage_cache_specs``)
wait for the tensor-parallel slice (ROADMAP queue 1 item 8); a port
worker refuses a plan of more than one stage, or with a device axis above
1, at hosting.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..models.base import ModelConfig

MAX_STAGES = 6  # reference ml/validator.py:427-430
# tlint: disable=TL006(read-only constant table — never mutated at runtime)
_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "float8_e4m3fn": 1}


def _dtype_bytes(dtype) -> int:
    """Bytes per element of a torch dtype (``torch.bfloat16`` reads as
    "torch.bfloat16") or of a JAX dtype name; 2 when unknown."""
    name = getattr(dtype, "__name__", None) or str(dtype)
    for k, v in _DTYPE_BYTES.items():
        if k in name:
            return v
    return 2


@dataclass
class WorkerCapacity:
    """What a worker advertises (reference STATS-RESPONSE carries
    available_gpu_memory, worker_thread.py:245-268; here the mesh shape
    matters too)."""

    node_id: str
    hbm_bytes: float
    n_devices: int = 1
    # workers advertising the same nonempty slice_id share one ICI domain
    # and are merged into a single planned mesh (_merge_co_slice) — TP/FSDP
    # between them rides ICI instead of a TCP stage hop
    slice_id: str = ""


@dataclass
class MemoryEstimate:
    params: int
    grads: int
    optimizer: int
    activations: int
    kv_cache: int
    total: int

    @classmethod
    def build(
        cls,
        cfg: ModelConfig,
        *,
        batch: int,
        seq_len: int,
        training: bool,
        optimizer: str = "adamw",
    ) -> "MemoryEstimate":
        pb = _dtype_bytes(cfg.dtype)
        n = cfg.param_count()
        params = n * pb
        grads = n * pb if training else 0
        # adam: m+v in fp32 (reference ml/utils.py:75-78); sgd: 0
        opt = 2 * n * 4 if (training and optimizer.startswith("adam")) else 0
        # recompute working set of ONE layer (only one alive under remat):
        # qkv/o projections (~4 d_model tensors), the two mlp streams
        # (d_ff), and — on the einsum attention path — the materialized
        # [B, heads, S, S] probabilities (flash never materializes them)
        layer_ws = batch * seq_len * (4 * cfg.d_model + 2 * cfg.d_ff) * pb
        if not cfg.flash_attention:
            layer_ws += batch * cfg.n_heads * seq_len * seq_len * pb
        if training:
            # one residual per layer boundary (saved under remat) + the
            # per-layer recompute working set
            act = batch * seq_len * cfg.d_model * pb * (cfg.n_layers + 4)
            act += layer_ws
        else:
            act = batch * seq_len * cfg.d_model * pb * 4 + layer_ws
        kv = (
            2
            * cfg.n_layers
            * batch
            * seq_len
            * cfg.n_kv_heads
            * cfg.head_dim
            * pb
            if not training
            else 0
        )
        total = int((params + grads + opt + act + kv) * 1.1)
        return cls(params, grads, opt, int(act), int(kv), total)


@dataclass
class StagePlan:
    """One pipeline stage: a contiguous layer range on one worker's mesh.

    ``first``/``last`` are pipeline *positions*; ``holds_head`` says which
    stage's params include final_norm + lm_head. They coincide except for
    tied embeddings over >1 stage, where the head (= the embedding matrix)
    lives on stage 0: there stages[-1].last=True but holds_head=False, and
    the driver finishes with ``head_forward`` on stage 0. Executors call
    ``stage_forward(..., first=s.first, last=s.last and s.holds_head)``."""

    worker_id: str
    layer_lo: int
    layer_hi: int
    first: bool  # pipeline position 0 — embeds tokens
    last: bool  # final pipeline position — its output feeds the head
    holds_head: bool = False  # params include final_norm (+ lm_head)
    mesh_axes: dict[str, int] = field(default_factory=dict)
    # other workers on the same ICI slice merged into this stage's mesh
    # (co-slice planning): they join the primary's multi-host mesh instead
    # of receiving a TCP stage hop of their own
    coworkers: list[str] = field(default_factory=list)

    @property
    def layer_range(self) -> tuple[int, int]:
        return (self.layer_lo, self.layer_hi)


def training_update_mode(axes: dict[str, int], training: bool) -> str:
    """THE zero1 routing predicate (docs/TRAINING.md): a training mesh
    with a data axis > 1 runs the ZeRO-1 train step — optimizer state
    sharded 1/dp per replica, weight update sharded with it — and
    anything else runs the unsharded step. One definition so the plan,
    the worker's optimizer init, and the capacity model below can never
    disagree about which layout a job gets."""
    return (
        "zero1"
        if training and int((axes or {}).get("data", 1)) > 1
        else "unsharded"
    )


@dataclass
class ShardingPlan:
    model_name: str
    stages: list[StagePlan]
    n_micro: int
    batch: int
    seq_len: int
    training: bool
    estimate: MemoryEstimate
    # how the optimizer step runs on this plan: "zero1" (optimizer state
    # + weight update sharded over the data axis, engine/training.py)
    # whenever a training stage carries data > 1, else "unsharded"
    update_mode: str = "unsharded"

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def stage_for(self, worker_id: str) -> StagePlan | None:
        for s in self.stages:
            if s.worker_id == worker_id:
                return s
        return None

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShardingPlan":
        return cls(
            model_name=d["model_name"],
            stages=[StagePlan(**s) for s in d["stages"]],
            n_micro=d["n_micro"],
            batch=d["batch"],
            seq_len=d["seq_len"],
            training=d["training"],
            estimate=MemoryEstimate(**d["estimate"]),
            # absent in pre-zero1 stored plans (DHT entries) — derive
            update_mode=d.get("update_mode", "unsharded"),
        )


class AssignmentError(RuntimeError):
    """No worker set can host the job (reference graphing.py:640-650)."""


# training jobs at/above this sequence length get a seq (ring-attention)
# axis automatically when devices remain after EP/TP
SEQ_PARALLEL_THRESHOLD = 8192


def _apply_mesh_hints(
    cfg: ModelConfig,
    cap: WorkerCapacity,
    training: bool,
    hints: dict[str, int],
    *,
    stage_layers: int,
    seq_len: int = 0,
) -> dict[str, int]:
    """Validate explicit per-axis requests (job spec ``parallelism`` field)
    and fill the remaining devices with fsdp/data."""
    n = cap.n_devices
    axes: dict[str, int] = {}
    used = 1
    for name, size in hints.items():
        size = int(size)
        if size <= 1:
            continue
        if name not in ("tensor", "expert", "seq", "stage", "fsdp", "data"):
            raise AssignmentError(f"unknown mesh axis {name!r}")
        if name in ("seq", "stage") and not training:
            # serving sessions take the KV-cache path, which neither the
            # in-mesh GPipe nor ring attention supports (ml/worker.py
            # dispatch policy) — reject at plan time, not per request
            raise AssignmentError(
                f"{name} parallelism applies to training jobs only"
            )
        if used * size > n:
            raise AssignmentError(
                f"parallelism hints need {used * size} devices, worker has {n}"
            )
        if name == "tensor" and (
            cfg.n_heads % size or cfg.n_kv_heads % size
        ):
            raise AssignmentError(f"tensor={size} does not divide head counts")
        if name == "expert" and (not cfg.moe or cfg.n_experts % size):
            raise AssignmentError(f"expert={size} invalid for this model")
        if name == "stage" and stage_layers % size:
            raise AssignmentError(
                f"stage={size} does not divide {stage_layers} layers"
            )
        if name == "seq":
            if cfg.sliding_window is not None:
                raise AssignmentError(
                    "seq parallelism does not support sliding-window models"
                )
            if seq_len % size:
                raise AssignmentError(
                    f"seq={size} does not divide seq_len={seq_len}"
                )
        axes[name] = size
        used *= size
    if axes.get("seq", 1) > 1 and axes.get("stage", 1) > 1:
        # the in-mesh GPipe program has no ring-attention path — honoring
        # one axis and silently ignoring the other would be worse than
        # refusing (ml/worker.py dispatch picks GPipe when both are set)
        raise AssignmentError(
            "seq and stage parallelism cannot be combined on one worker"
        )
    rest = n // used
    if rest > 1 and "fsdp" not in axes and "data" not in axes:
        axes["fsdp" if training else "data"] = rest
    return axes


def _mesh_axes_for(
    cfg: ModelConfig,
    cap: WorkerCapacity,
    training: bool,
    *,
    seq_len: int = 0,
    stage_layers: int = 0,
    mesh_hints: dict[str, int] | None = None,
) -> dict[str, int]:
    """Within one worker: explicit ``mesh_hints`` (job spec ``parallelism``)
    win outright; otherwise MoE models first claim an expert axis (EP —
    required by BASELINE config 5, Mixtral), then a TP degree that divides
    both head counts, then long-context *training* jobs claim a seq
    (ring-attention) axis; remaining devices go to fsdp (training) or data
    (serving). All axes ride ICI inside the worker's slice."""
    if mesh_hints:
        return _apply_mesh_hints(
            cfg, cap, training, mesh_hints,
            stage_layers=stage_layers, seq_len=seq_len,
        )
    n = cap.n_devices
    ep = 1
    if cfg.moe:
        for cand in (8, 4, 2, 1):
            if cand <= n and cfg.n_experts % cand == 0 and n % cand == 0:
                ep = cand
                break
    rem = n // ep
    tp = 1
    for cand in (8, 4, 2, 1):
        if (
            cand <= rem
            and cfg.n_kv_heads % cand == 0
            and cfg.n_heads % cand == 0
            and rem % cand == 0
        ):
            tp = cand
            break
    rest = rem // tp
    sp = 1
    if training and seq_len >= SEQ_PARALLEL_THRESHOLD and rest > 1:
        # ring attention shards activations over seq — the axis that actually
        # bounds long-context memory (SURVEY §5); KV-cache decode never takes
        # this path, so serving plans skip it
        for cand in (8, 4, 2):
            if cand <= rest and seq_len % cand == 0 and rest % cand == 0:
                sp = cand
                break
        rest //= sp
    axes = {"fsdp" if training else "data": rest, "tensor": tp}
    if sp > 1:
        axes["seq"] = sp
    if ep > 1:
        axes["expert"] = ep
    return axes


def _per_device_bytes(
    est: MemoryEstimate,
    axes: dict[str, int],
    *,
    frac: float = 1.0,
    cfg: ModelConfig | None = None,
    batch: int = 1,
    exclude_model_bytes: float = 0.0,
    training: bool = False,
) -> float:
    """Bytes each device must hold for (a ``frac`` layer-fraction of) the
    estimate under ``axes``. Sharding geometry: params/grads shard over
    tensor×fsdp×expert×stage but REPLICATE over data (the r3 bug: a
    4-device worker "fit" a model each chip could not hold — aggregate HBM
    is only reachable for axes that actually shard the tensor); the
    OPTIMIZER state additionally shards over data on zero1 training plans
    (engine/training.py: ZeRO-1 stores it 1/dp per replica — the capacity
    this buys is exactly why the planner picks zero1 whenever dp > 1).
    Activations and KV shard over the data axis only when the batch
    divides it, and KV over tensor only when the kv heads divide it —
    mirroring the worker's runtime degrade rules
    (ml/worker.py::_cache_specs_for), which otherwise REPLICATE those
    arrays per device."""

    def ax(name: str) -> int:
        return max(int(axes.get(name, 1)), 1)

    dp = ax("data")
    dp_eff = dp if batch % dp == 0 else 1
    tp_kv = ax("tensor")
    if cfg is not None and cfg.n_kv_heads % tp_kv:
        tp_kv = 1
    shard_model = ax("tensor") * ax("fsdp") * ax("expert") * ax("stage")
    shard_opt = shard_model * (
        dp if training_update_mode(axes, training) == "zero1" else 1
    )
    shard_act = ax("fsdp") * dp_eff * ax("seq")
    shard_kv = dp_eff * tp_kv
    pg_bytes = max(
        est.params + est.grads - exclude_model_bytes, 0.0
    )
    model = pg_bytes * frac / shard_model
    opt = est.optimizer * frac / shard_opt
    act = est.activations * frac / shard_act
    kv = est.kv_cache * frac / shard_kv
    return (model + opt + act + kv) * 1.1


def _merge_co_slice(
    workers: list[WorkerCapacity],
) -> tuple[list[WorkerCapacity], dict[str, list[str]]]:
    """Workers advertising the same nonempty ``slice_id`` share one ICI
    domain (hosts of one TPU slice): merge each group into a single logical
    capacity — pooled HBM, pooled devices — so planning emits ONE mesh whose
    TP/FSDP axes ride ICI instead of a TCP stage hop between the hosts. The
    largest-HBM member (id tiebreak) is the primary/executor; the rest ride
    the emitted stage's ``coworkers`` list."""
    groups: dict[str, list[WorkerCapacity]] = {}
    out: list[WorkerCapacity] = []
    for w in workers:
        if w.slice_id:
            groups.setdefault(w.slice_id, []).append(w)
        else:
            out.append(w)
    co: dict[str, list[str]] = {}
    for sid, grp in groups.items():
        if len(grp) == 1:
            out.append(grp[0])
            continue
        grp = sorted(grp, key=lambda g: (-g.hbm_bytes, g.node_id))
        primary = grp[0]
        out.append(
            WorkerCapacity(
                node_id=primary.node_id,
                hbm_bytes=sum(g.hbm_bytes for g in grp),
                n_devices=sum(g.n_devices for g in grp),
                slice_id=sid,
            )
        )
        co[primary.node_id] = [g.node_id for g in grp[1:]]
    return out, co


def plan_sharding(
    cfg: ModelConfig,
    workers: list[WorkerCapacity],
    *,
    model_name: str = "",
    batch: int = 1,
    seq_len: int = 2048,
    training: bool = False,
    n_micro: int | None = None,
    mesh_hints: dict[str, int] | None = None,
    merge_co_slice: bool = False,
) -> ShardingPlan:
    """Assign the model to workers.

    Single-worker fit is preferred (whole model, one mesh, zero cross-node
    traffic). Otherwise layers split into contiguous stages proportional to
    worker capacity — best-fit ordering, largest worker first (reference
    best-fit prefers the previous worker, graphing.py:730-761; contiguity is
    what matters on TPU since stage boundaries are the only cross-node hops).

    ``merge_co_slice`` (opt-in, MLConfig.co_slice_planning): pool same-
    slice_id workers into one planned mesh. Requires a runtime where the
    primary worker's JAX process can address the whole slice's devices
    (single-controller over the slice; the coworker entries let the
    validator reserve capacity on every member) — with the default
    per-process runtime such a plan cannot execute, so the merge is off
    unless the deployment asserts support.
    """
    if not workers:
        raise AssignmentError("no workers available")
    co_slice: dict[str, list[str]] = {}
    if merge_co_slice:
        workers, co_slice = _merge_co_slice(workers)
    est = MemoryEstimate.build(
        cfg, batch=batch, seq_len=seq_len, training=training
    )
    ranked = sorted(workers, key=lambda w: -w.hbm_bytes)

    # 1) whole-model fit on the single best worker — both in aggregate AND
    # per device under the mesh that would actually be emitted (replicated
    # tensors cannot borrow a neighbor chip's HBM)
    best = ranked[0]
    if est.total <= best.hbm_bytes:
        axes = _mesh_axes_for(
            cfg, best, training,
            seq_len=seq_len,
            stage_layers=cfg.n_layers,
            mesh_hints=mesh_hints,
        )
        per_dev_hbm = best.hbm_bytes / max(best.n_devices, 1)
        if _per_device_bytes(
            est, axes, cfg=cfg, batch=batch, training=training
        ) <= per_dev_hbm:
            stage = StagePlan(
                worker_id=best.node_id,
                layer_lo=0,
                layer_hi=cfg.n_layers,
                first=True,
                last=True,
                holds_head=True,
                mesh_axes=axes,
                coworkers=co_slice.get(best.node_id, []),
            )
            return ShardingPlan(
                model_name=model_name,
                stages=[stage],
                # zero1 needs whole micro-batches per replica: default the
                # micro count to the dp degree (1 micro per replica, the
                # bitwise-pinned configuration — engine/training.py)
                n_micro=n_micro or max(
                    axes.get("data", 1) if training else 1, 1
                ),
                batch=batch,
                seq_len=seq_len,
                training=training,
                estimate=est,
                update_mode=training_update_mode(axes, training),
            )

    # 2) pipeline split: per-layer cost + embedding/head overheads
    pb = _dtype_bytes(cfg.dtype)
    per_layer = (est.total - 2 * cfg.vocab_size * cfg.d_model * pb) / max(
        cfg.n_layers, 1
    )
    emb_bytes = cfg.vocab_size * cfg.d_model * pb * (1 if cfg.tie_embeddings else 2)

    chosen: list[WorkerCapacity] = []
    cap_layers: list[int] = []
    remaining = cfg.n_layers
    for i, w in enumerate(ranked[:MAX_STAGES]):
        budget = w.hbm_bytes
        # per-device constraint for this worker's would-be mesh
        # (stage_layers=0 sidesteps the stage-divisibility hint check, which
        # re-runs for real at emission time below)
        axes = _mesh_axes_for(
            cfg, w, training, seq_len=seq_len, stage_layers=0,
            mesh_hints=mesh_hints,
        )
        shard_model = 1
        for name in ("tensor", "fsdp", "expert", "stage"):
            shard_model *= max(int(axes.get(name, 1)), 1)
        dev_budget = w.hbm_bytes / max(w.n_devices, 1)
        if i == 0:
            budget -= emb_bytes  # embeddings (tied → head too) pin to stage 0
            dev_budget -= emb_bytes / shard_model
        # embeddings are accounted against stage 0's budget above, so the
        # per-layer cost must exclude them just like the aggregate term does
        per_layer_dev = _per_device_bytes(
            est, axes, frac=1.0 / max(cfg.n_layers, 1), cfg=cfg, batch=batch,
            exclude_model_bytes=2 * cfg.vocab_size * cfg.d_model * pb,
            training=training,
        )
        fit = min(int(budget // per_layer), int(dev_budget // per_layer_dev))
        if fit <= 0:
            continue
        take = min(fit, remaining)
        chosen.append(w)
        cap_layers.append(take)
        remaining -= take
        if remaining == 0:
            break
    if remaining > 0:
        raise AssignmentError(
            f"model needs {est.total / 1e9:.1f} GB; "
            f"{len(workers)} workers (≤{MAX_STAGES} stages) cannot host it"
        )

    stages = []
    lo = 0
    for i, (w, n_l) in enumerate(zip(chosen, cap_layers)):
        is_last = i == len(chosen) - 1
        stages.append(
            StagePlan(
                worker_id=w.node_id,
                layer_lo=lo,
                layer_hi=lo + n_l,
                first=i == 0,
                last=is_last,
                holds_head=is_last,
                mesh_axes=_mesh_axes_for(
                    cfg, w, training,
                    seq_len=seq_len,
                    stage_layers=n_l,
                    mesh_hints=mesh_hints,
                ),
                coworkers=co_slice.get(w.node_id, []),
            )
        )
        lo += n_l
    # tied embeddings: lm_head IS the stage-0 embedding matrix → the head
    # lives on stage 0 and the last stage ships hidden back for logits
    # (head_forward hop; see StagePlan docstring).
    if cfg.tie_embeddings and len(stages) > 1:
        stages[-1].holds_head = False
        stages[0].holds_head = True

    micro = n_micro or max(2 * len(stages), 1) if len(stages) > 1 else (n_micro or 1)
    return ShardingPlan(
        model_name=model_name,
        stages=stages,
        n_micro=micro,
        batch=batch,
        seq_len=seq_len,
        training=training,
        estimate=est,
        update_mode=(
            "zero1"
            if any(
                training_update_mode(s.mesh_axes, training) == "zero1"
                for s in stages
            )
            else "unsharded"
        ),
    )


__all__ = [
    "AssignmentError", "MemoryEstimate", "ShardingPlan", "StagePlan",
    "WorkerCapacity", "plan_sharding", "training_update_mode",
]
