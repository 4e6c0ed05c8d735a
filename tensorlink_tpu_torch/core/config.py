"""Layered configuration system.

Mirrors the reference's four config layers (SURVEY §5; reference
nodes/nodes.py:16-77, bin/run_node.py:213-246, .tensorlink.env,
tensorlink/config/config.json) as one coherent scheme:

1. Role config dataclasses (programmatic API) — :class:`NodeConfig` and
   subclasses.
2. Operator ``config.json`` — node type / mode / endpoint / ml caps.
3. Environment file (``.tensorlink_tpu.env``) — keys, persisted port
   assignments, chain overrides.
4. Packaged defaults — seed validators, default models, contract addresses.

Unlike the reference there is also a first-class ``MeshConfig`` describing the
TPU topology the node contributes (axis names/sizes, dtype policy) — on TPU the
unit of capacity is a slice of a device mesh, not "GPU bytes".
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

DEFAULT_ENV_FILE = ".tensorlink_tpu.env"

# Packaged defaults (reference: tensorlink/config/config.json + models.json).
# tlint: disable=TL006(read-only defaults table — EnvFile overlays copy, never mutate)
DEFAULT_CONFIG: dict[str, Any] = {
    "seed_validators": [],  # [(host, port), ...]
    "default_models": ["Qwen/Qwen3-8B"],
    "free_job_max_time": 3600.0,  # reference validator_thread.py:19
    "max_wait_time": 150.0,  # reference ml/module.py:58
    "worker_recruit_timeout": 3.0,  # reference validator_thread.py:871
    "job_request_timeout": 120.0,  # reference user_thread.py:406
    "api": {
        "max_concurrent": 100,  # reference api/node.py:537
        "stream_token_timeout": 30.0,
        "request_timeout": 300.0,
    },
}


@dataclass
class MLConfig:
    """ML-engine knobs (reference config.json "ml" block, run_node.py:228-246)."""

    max_memory_gb: float | None = None  # cap on HBM the node offers
    max_module_bytes: float | None = None  # force sharding below this size
    # ICI-slice identity this worker advertises; co-slice workers merge into
    # one planned mesh (parallel/planner.py::_merge_co_slice). Auto-detected
    # from device.slice_index on TPU when unset (and TPU_NAME identifies the
    # pod — without it the index alone would collide across pods).
    slice_id: str = ""
    # validator: enable co-slice merging at plan time. Off by default — a
    # merged plan needs a runtime where one worker process addresses the
    # whole slice's devices (see plan_sharding docstring).
    co_slice_planning: bool = False
    # multi-controller runtime (parallel/multihost.py): set on every host of
    # a slice to join one jax.distributed job; jax.devices() then spans the
    # slice. Env fallbacks: TLTPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID.
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    trusted: bool = False  # reference: pickle mode. Here: may run user jax code
    dtype: str = "bfloat16"
    max_seq_len: int = 4096
    # TPU-specific: padding buckets to bound XLA recompilation (SURVEY §7.3.5)
    seq_buckets: tuple[int, ...] = (128, 512, 1024, 2048, 4096)
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8)
    # serving: how many concurrent API requests one batched decode may
    # coalesce (ml/batching.py); bounded by the largest batch bucket
    max_serve_batch: int = 8
    # continuous batching over the paged KV cache (engine/continuous.py,
    # docs/SERVING.md): requests join the RUNNING slot batch at decode-chunk
    # boundaries and finished rows free their KV pages immediately, instead
    # of window-coalescing into run-to-completion static batches. Single-
    # stage jobs decode on the worker's slot engine; pipelined jobs run
    # slot admission through the session path (ml/batching.py). Models the
    # paged engine can't serve (sliding-window attention) fall back to the
    # windowed batcher automatically; int8-KV models ("int8+kv") serve
    # CONTINUOUS — the paged cache stores int8 pages natively (kv_quant).
    continuous_batching: bool = True
    cont_max_slots: int = 8  # concurrent requests per model (B of the slot batch)
    cont_page_size: int = 16  # KV positions per page
    cont_chunk_steps: int = 8  # decode steps between admission boundaries
    # chunked prefill (engine/continuous.py): an admitted prompt prefills
    # in fixed-shape chunks of this many tokens interleaved with decode
    # chunks, so a long admission never stalls co-resident decodes for
    # more than one chunk (flat TTFT under mixed traffic). 0 = legacy
    # monolithic admission (whole-prompt dense prefill; disables the
    # prefix cache, which needs offset-carrying suffix prefill).
    prefill_chunk: int = 128
    # automatic prefix caching over the paged KV cache (docs/SERVING.md):
    # full KV pages are kept resident keyed by their exact token chain
    # from position 0; admission maps the longest cached prefix into the
    # new slot's block table (zero prefill compute for the hit region),
    # the first divergent page is copy-on-write, and unreferenced pages
    # evict LRU when the allocator runs dry. Hits are bitwise the KV the
    # slot would have computed — streams are identical cache on or off.
    prefix_cache: bool = True
    # tiered prefix cache (engine/kvtier.py, docs/SERVING.md "Tiered
    # prefix cache"): > 0 arms a host-RAM tier of this many pages —
    # refcount-0 prefix pages DEMOTE to host numpy at eviction instead
    # of being destroyed, and admission promotes host residents back
    # into HBM bitwise (device_put, zero new compiled programs). The
    # tier also feeds the fleet digest map so siblings can pull
    # prefixes cross-replica on a local miss. 0 keeps seed behavior
    # (evicted pages die).
    cont_host_tier_pages: int = 0
    # paged KV cache storage dtype (engine/paged.py, docs/SERVING.md
    # "Quantized KV"): "int8" stores KV pages int8 with per-(page,
    # position, head) symmetric scales, quantized at the one page-write
    # path and dequantized in-kernel at the page fetch — KV bytes halve,
    # so ~2x serving slots and ~2x prefix-cache residency at fixed HBM.
    # "int4" packs two values per byte at the same scale granularity:
    # ~4x at a byte-matched budget (vs bf16), with a looser but still
    # context-length-independent divergence bound. Streams stay
    # bit-identical to each other across every lifecycle path
    # (solo/co-batched/recovered/preempted, cache on/off); only the
    # fp-vs-quantized comparison differs, bounded in tests. Default
    # int8 (the PR 7 one-release opt-in window has elapsed); "none" is
    # the explicit opt-out. Models served with quant="int8+kv" force
    # quantized pages.
    kv_quant: str = "int8"  # "none" | "int8" | "int4"
    # -- multi-tenant co-hosting (docs/SERVING.md "Co-hosting multiple
    # models"): one physical KV page pool shared by every co-hosted
    # model with matching page geometry (the many-small-fine-tunes
    # shape), under per-model page quotas with cross-model preemption
    # by scheduler rank. 0 keeps today's private pool per engine.
    cont_pool_pages: int = 0  # TOTAL shared pool pages (0 = private pools)
    # default per-model page quota on the shared pool (0 = uncapped —
    # bounded by the pool alone); a model spec's "page_quota" overrides
    cont_pool_quota: int = 0
    # EQuARX-style quantized collectives (parallel/ring.py): ring-attention
    # K/V hops move int8 chunks + scales over ICI with a deterministic f32
    # reduction — ~half the hop bytes at a bounded, test-pinned divergence.
    # Applied via ModelConfig.collective_quant at SERVING stage load only
    # (the quantize round() has a zero gradient — training keeps exact
    # collectives). GSPMD tensor-parallel collectives are XLA-inserted and
    # unaffected; ring.quantized_psum/quantized_all_gather are the
    # building blocks for explicit shard_map paths.
    collective_quant: bool = False
    # -- explicit tensor parallelism (docs/SHARDING.md): shard the paged
    # serving hot path over a tp mesh axis — attention heads and MLP
    # columns as weight shards, KV pages by kv head, every control-state
    # array replicated, per-chunk activation gathers in a fixed order so
    # streams stay bit-identical to tp=1. The whole mesh is ONE
    # placement unit to the fleet router. 1 = single-device (today's
    # path, byte-identical programs). Models the specs can't shard
    # (MoE, indivisible head counts) fall back to the static batcher
    # through the worker's normal refusal seam.
    tensor_parallel: int = 1
    # -- disaggregated prefill/decode pools (docs/SERVING.md
    # "Disaggregated prefill/decode"): the serving role this worker
    # advertises. "prefill" workers take new continuous admissions, fill
    # their pages through the normal ragged grants, then freeze each
    # slot at the prefill→decode boundary and ship it to a decode-pool
    # worker through the migration export/stage/adopt path — so an
    # interactive stream's inter-token latency never shares a step with
    # a neighbor's long prompt. "decode" workers are excluded from
    # placement and serve as handoff destinations. "mixed" (default)
    # keeps the single-pool behavior. Placement and the decode-pool push
    # are the validator's job (ml/validator.py); a prefill worker with
    # no reachable decode pool degrades to mixed behavior per slot
    # (abort_handoff — never a dropped or slower stream).
    worker_role: str = "mixed"  # "prefill" | "decode" | "mixed"
    # speculative decoding inside the unified ragged step (engine/
    # continuous.py, docs/SERVING.md "Speculative decoding"): an opted-in
    # request ({"speculative": true}) packs a host-drafted prompt-lookup
    # block as extra valid rows of its decode slot and the one compiled
    # step verifies all of them in-program — multi-token decode per pass
    # on repetitive/extractive text, bit-identical streams always, with
    # a per-request acceptance-rate kill switch so a bad draft mix can
    # never make it a slowdown. Default ON (the PR 11 one-release
    # opt-in window has elapsed, mirroring the kv_quant flip): the
    # engine capability is armed everywhere, requests still opt in
    # per-call; spec_decode=False is the explicit opt-out.
    spec_decode: bool = True
    # max draft tokens per verify pass (extra ragged rows per
    # speculating slot; capped by prefill_chunk - 1)
    spec_draft: int = 8
    # optional TOTAL draft tokens per step shared round-robin-fair
    # across speculating slots (0 = each gets a full draft) — bounds the
    # extra verify compute per step like prefill_budget bounds prefill
    spec_budget: int = 0
    # -- SLO-aware request scheduling (engine/scheduler.py) --------------
    # priority class a request gets when the API body carries none:
    # "interactive" | "batch" | "best_effort". Classes order admission
    # (aging keeps low classes starvation-free) and bound preemption —
    # see docs/SERVING.md "Scheduling".
    default_priority: str = "interactive"
    # per-class queued-request cap: past it submissions fail fast (the
    # API layer turns the rejection into 429 + Retry-After) instead of
    # queueing until the client times out
    sched_queue_cap: int = 64
    # starvation-free aging: a queued request's effective class improves
    # by one rank every this-many admission rounds (one round = one
    # engine chunk), so sustained interactive load delays batch work but
    # never parks it forever
    sched_aging_ticks: int = 32
    # cache-backed preemption: a higher-class request that would miss
    # admission may evict the lowest-class / most-recently-admitted slot
    # through the prefix-cache promotion path and re-queue it — the
    # resumed stream is bit-identical to an uninterrupted run
    sched_preemption: bool = True
    # "slo" (priority + aging + preemption) or "fcfs" (PR-2 behavior:
    # strict arrival order, no preemption) — the bench's baseline knob
    sched_policy: str = "slo"
    # backpressure: reject admission when the estimated queue wait for
    # the request's class exceeds this many seconds (0 disables the
    # wait check; the queue cap still applies)
    sched_max_wait_s: float = 60.0
    # -- fleet serving (tensorlink_tpu/fleet, docs/SERVING.md "Fleet
    # serving"): N replicas of each hosted model behind a cache- and
    # SLO-aware router. host_model plans this many independent replica
    # jobs (fewer when capacity runs out — the fleet degrades, the host
    # never fails for lack of spares) and routes each request by
    # prefix-cache affinity + per-class load; 1 keeps today's
    # single-replica path byte-identical.
    fleet_replicas: int = 1
    # start the FleetAutopilot control loop per hosted fleet: rebalance
    # hot replicas, scale the decode pool, run rolling deploys — every
    # action through the drain/migration path (zero dropped tokens)
    fleet_autopilot: bool = False
    fleet_autopilot_interval_s: float = 2.0
    # router telemetry refresh cadence (seconds between replica-view
    # pulls; route() also refreshes lazily at this cadence)
    fleet_refresh_s: float = 0.5
    # streamed requests: >0 runs the decode as fully-compiled on-device
    # chunks of this many steps (one host round trip per chunk instead of
    # per token — engine/generate.py::generate_chunked); 0 keeps the
    # per-token host loop (lowest time-to-first-delta on local devices).
    # Set 16-64 when the chip is reached over a high-latency tunnel; a
    # stop-sequence cancel still cuts the stream at the exact token (only
    # device compute, not emission, runs to the chunk end).
    stream_chunk_steps: int = 0
    # pre-compile the serving engine at host time for this many decode
    # tokens (engine.warmup) — 0 skips; when set, "ready" means every batch
    # bucket's smallest-prompt prefill + this token budget's decode loop is
    # compiled (other prompt/budget buckets still compile on first use)
    warmup_tokens: int = 0
    # validator: host DEFAULT_CONFIG["default_models"] at startup (reference
    # auto-loads popular/default models, ml/validator.py:169-365); off by
    # default so local tests never pull multi-GB checkpoints
    autoload_default_models: bool = False
    # -- control-plane crash safety (core/journal.py, docs/FAILURE_MODEL.md
    # "Control plane"): the validator's write-ahead journal of hosting,
    # admissions, delivered-token high-water marks, migration tickets and
    # autopilot intents. Restart + DistributedValidator.recover() replays
    # it, re-attaches live replicas and expires stranded tickets.
    journal: bool = True
    # plain (non-intent) records are fsync-batched: flush when this many
    # buffered or when the window elapses, whichever first. Intents always
    # fsync write-ahead regardless.
    journal_flush_every: int = 16
    journal_flush_s: float = 0.05
    # delivered-token high-water marks are journaled every N streamed
    # tokens per request (chunk granularity — the journal is an audit
    # floor; the worker's live count is authoritative at recovery)
    journal_hwm_every: int = 16
    # workers: finished orphaned streams (client/validator gone before the
    # final response was delivered) are kept for re-attach up to this many
    # entries / this long, whichever trips first. Live orphans aren't
    # bounded here — allocator pressure sheds them via preemption as usual.
    orphan_keep: int = 64
    orphan_ttl_s: float = 180.0
    # the torch device a worker serves on (port-only; the counterpart of
    # JAX_PLATFORMS): None is the CUDA card, and a worker with no card
    # refuses to start; "cpu" runs the kernels' plain versions on the host
    device: str | None = None


@dataclass
class MeshConfig:
    """Shape of the device mesh a node runs over.

    Axis names follow the scaling-book convention: data / fsdp / tensor /
    expert / sequence / stage. ``axis_sizes`` of -1 means "all remaining local
    devices".
    """

    axes: tuple[str, ...] = ("data", "tensor")
    axis_sizes: tuple[int, ...] = (1, -1)
    platform: str | None = None  # None = jax default; "cpu" for tests

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dict(zip(self.axes, self.axis_sizes))
        rem = n_devices
        wildcard = None
        for ax, s in sizes.items():
            if s == -1:
                if wildcard is not None:
                    raise ValueError("only one mesh axis may be -1")
                wildcard = ax
            else:
                if rem % s != 0:
                    raise ValueError(
                        f"axis {ax}={s} does not divide device count {rem}"
                    )
                rem //= s
        if wildcard is not None:
            sizes[wildcard] = rem
        elif rem != 1:
            raise ValueError(
                f"mesh {sizes} does not use all {n_devices} devices"
            )
        return sizes


@dataclass
class NodeConfig:
    """Base node configuration (reference BaseNodeConfig, nodes/nodes.py:16-45)."""

    role: str = "node"
    host: str = "0.0.0.0"
    port: int | None = None  # None = ephemeral / persisted in env file
    debug: bool = True
    debug_level: int = 20  # logging level; 5 = VERBOSE
    # structured logging (core/logging.py): one JSON object per line
    # carrying ts/level/tag/msg and the active trace_id when a request
    # span is live — joinable against /trace. Default keeps the colored
    # human format.
    json_logs: bool = False
    local_test: bool = False  # force 127.0.0.1, no UPnP (reference smart_node.py:230)
    upnp: bool = False
    off_chain: bool = True  # reference: on_chain flag inverted; off-chain default
    endpoint: bool = False  # serve the HTTP API (validators)
    endpoint_host: str = "127.0.0.1"
    endpoint_port: int = 64747  # reference test endpoint port
    seed_validators: list[tuple[str, int]] = field(default_factory=list)
    key_dir: str = "keys"
    log_dir: str = "logs"
    env_file: str = DEFAULT_ENV_FILE
    ml: MLConfig = field(default_factory=MLConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    utilization: bool = True  # offer capacity (workers)
    duplicate: str = ""  # role suffix for same-host multi-node tests
    # native shm message ring for the ML↔net bridge (core/ring.py); falls
    # back to mp.Queue when the C++ toolchain / platform can't build it
    native_ipc: bool = True
    # platform-service cadences (reference: keeper write every 300 s,
    # JobMonitor 30 s cycle — validator_thread.py:978-1011, job_monitor.py:104)
    keeper_interval: float = 300.0
    monitor_interval: float = 30.0
    proposal_interval: float = 3600.0  # contract round cadence (0 = manual)
    # seconds a job's worker may be unreachable before the monitor recruits
    # a replacement (platform/job_monitor.py)
    offline_grace: float = 5.0
    # deterministic fault-injection plan (core/faults.py): {} disables the
    # layer entirely — no fault-site code runs on the hot paths. A non-empty
    # plan is installed in BOTH halves of the node: the spawned network
    # process (p2p.send / connection.frame sites) and the ML executor
    # (worker.session_step / worker.train_step sites).
    faults: dict = field(default_factory=dict)

    def effective_host(self) -> str:
        return "127.0.0.1" if self.local_test else self.host


@dataclass
class WorkerConfig(NodeConfig):
    role: str = "worker"
    mining: bool = False  # reference: miner subprocess mgmt (run_node.py:135-194)


@dataclass
class ValidatorConfig(NodeConfig):
    role: str = "validator"
    endpoint: bool = True


@dataclass
class UserConfig(NodeConfig):
    role: str = "user"


def _coerce(cls, data: dict[str, Any]):
    """Build a dataclass from a dict, recursing into nested dataclass fields
    and ignoring unknown keys (operator config files may carry extras)."""
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _coerce(ftype, v)
        elif f.name == "seed_validators":
            v = [tuple(x) for x in v]
        kwargs[f.name] = v
    return cls(**kwargs)


# tlint: disable=TL006(read-only constant table — never mutated at runtime)
ROLE_CONFIGS = {
    "worker": WorkerConfig,
    "validator": ValidatorConfig,
    "user": UserConfig,
}


def load_config(path: str | Path) -> NodeConfig:
    """Load an operator config.json (reference bin/run_node.py:213-246)."""
    raw = json.loads(Path(path).read_text())
    role = raw.get("role", raw.get("node", {}).get("type", "worker"))
    cls = ROLE_CONFIGS.get(role, NodeConfig)
    flat = dict(raw)
    flat.update(raw.get("node", {}))
    flat["role"] = role
    # Reference mode mapping (run_node.py:60-76): local / upnp / on_chain
    mode = flat.pop("mode", None)
    if mode == "local":
        flat.update(local_test=True, upnp=False, off_chain=True)
    elif mode == "upnp":
        flat.update(local_test=False, upnp=True, off_chain=True)
    elif mode == "on_chain":
        flat.update(local_test=False, upnp=True, off_chain=False)
    return _coerce(cls, flat)


class EnvFile:
    """Tiny KEY=VALUE env file with persisted port assignments keyed by node
    id (reference .tensorlink.env, smart_node.py:84,1166-1198)."""

    def __init__(self, path: str | Path = DEFAULT_ENV_FILE):
        self.path = Path(path)

    def read(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, _, v = line.partition("=")
                    out[k.strip()] = v.strip()
        return out

    def get(self, key: str, default: str | None = None) -> str | None:
        return self.read().get(key, os.environ.get(key, default))

    def set(self, key: str, value: str) -> None:
        data = self.read()
        data[key] = value
        self.path.write_text(
            "".join(f"{k}={v}\n" for k, v in sorted(data.items()))
        )

    def port_for(self, node_id: str, default: int | None = None) -> int | None:
        v = self.get(f"PORT_{node_id[:16]}")
        return int(v) if v is not None else default

    def save_port(self, node_id: str, port: int) -> None:
        self.set(f"PORT_{node_id[:16]}", str(port))
