"""Node runners — the user-facing processes (reference nodes/nodes.py).

``WorkerNode()`` / ``ValidatorNode()`` / ``UserNode()`` spawn their network
process (role server, imports neither torch nor jax) and run the ML side
in the calling process: an event-driven executor thread for
workers/validators, nothing for users (the DistributedModel drives
synchronously through ``send_request``).

Reference mapping: BaseNode/Worker/Validator/User (nodes/nodes.py:106-414)
with ``send_request`` (nodes.py:201-235) — minus the global mpc_lock, which
the per-request-future bridge (nodes/ipc.py) makes unnecessary.
"""

from __future__ import annotations

import multiprocessing as mp
import threading
from typing import Any

from tensorlink_tpu_torch.core.config import (
    NodeConfig,
    UserConfig,
    ValidatorConfig,
    WorkerConfig,
)
from tensorlink_tpu_torch.core.logging import get_logger
from tensorlink_tpu_torch.nodes.ipc import BridgeQueues, MLBridge
from tensorlink_tpu_torch.nodes.roles import run_server


def _spawn_ctx():
    # spawn, not fork: the ML process holds torch/CUDA state that must never
    # be inherited by the network process (reference nodes.py:103 does the
    # same).
    return mp.get_context("spawn")


class BaseNode:
    CONFIG = NodeConfig

    def __init__(self, config: NodeConfig | None = None, **overrides: Any):
        if config is None:
            config = self.CONFIG(**overrides)
        elif overrides:
            from dataclasses import replace

            config = replace(config, **overrides)
        self.config = config
        self.role = config.role
        if config.json_logs:
            # flip BEFORE the first logger so every line of this process
            # (and the executor threads it spawns) is one JSON object
            from tensorlink_tpu_torch.core.logging import set_json_logs

            set_json_logs(True)
        self.log = get_logger(f"node.{self.role}{config.duplicate}")
        self.queues = self._make_queues()
        self.bridge = MLBridge(self.queues)
        self._proc: mp.process.BaseProcess | None = None
        self._ml_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.node_id: str | None = None
        self.port: int | None = None

    def _make_queues(self) -> BridgeQueues:
        """Native shm message ring when available (C++ tlring — blocking
        reads, TLTS payloads, no pickling); mp.Queue otherwise."""
        if self.config.native_ipc:
            try:
                from tensorlink_tpu_torch.core.ring import RingChannel, ring_supported

                if ring_supported():
                    return BridgeQueues(
                        cmd=RingChannel(), resp=RingChannel(), work=RingChannel()
                    )
            except Exception as e:
                self.log.warning("native ipc unavailable (%s); using mp.Queue", e)
        ctx = _spawn_ctx()
        return BridgeQueues(cmd=ctx.Queue(), resp=ctx.Queue(), work=ctx.Queue())

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "BaseNode":
        if self._proc is not None:
            return self
        ctx = _spawn_ctx()
        self._proc = ctx.Process(
            target=run_server,
            args=(self.role, self.config, self.queues),
            name=f"net-{self.role}",
            daemon=True,
        )
        self._proc.start()
        rid, ok, info = self.queues.resp.get(timeout=60)
        if rid != -1 or not ok:
            raise RuntimeError(f"network process failed to start: {info}")
        self.node_id, self.port = info["id"], info["port"]
        self.bridge.start()
        if self.config.seed_validators:
            self.send_request("bootstrap", {})
        self._start_ml()
        self.log.info("up id=%s port=%s", self.node_id[:12], self.port)
        return self

    def _start_ml(self) -> None:  # overridden by roles with an ML executor
        pass

    def stop(self) -> None:
        import queue as queue_mod

        self._stop.set()
        if self._ml_thread is not None:
            try:
                self.queues.work.put(("_stop", None))
            # tlint: disable=TL005(ring closed by a dead peer / full — the join below is the real stop)
            except (OSError, EOFError, queue_mod.Full):
                pass  # ring closed by a dead peer / full — join regardless
            self._ml_thread.join(timeout=10)
            self._ml_thread = None
        if self._proc is not None:
            try:
                self.queues.cmd.put((0, "_stop", None))
            # tlint: disable=TL005(network process already gone — the join below is the real stop)
            except (OSError, EOFError, queue_mod.Full):
                pass
            self._proc.join(timeout=10)
            if self._proc.is_alive():
                self._proc.terminate()
            self._proc = None
        self.bridge.close()
        for q in (self.queues.cmd, self.queues.resp, self.queues.work):
            release = getattr(q, "release", None)
            if release is not None:
                try:
                    release()
                # tlint: disable=TL005(teardown of shm rings whose peer may have released first)
                except Exception:
                    pass

    def crash(self) -> None:
        """Abrupt node death (fault injection, core/faults.py): kill the
        network process with no shutdown courtesy so peers observe a dropped
        connection — exactly what a real worker loss looks like. Unlike
        :meth:`stop`, nothing is flushed and the ML loop is expected to be
        the caller (it returns right after). ``stop()`` stays safe to call
        afterwards."""
        self._stop.set()
        proc, self._proc = self._proc, None
        if proc is not None:
            proc.kill()
            proc.join(timeout=5)
        self._ml_thread = None  # the calling ML thread is exiting itself
        self.bridge.close()

    def __enter__(self) -> "BaseNode":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- RPC into the network process ----------------------------------
    def send_request(self, verb: str, payload: Any = None, timeout: float = 30.0):
        return self.bridge.request(verb, payload, timeout=timeout)

    def status(self) -> dict:
        return self.send_request("status")

    def connect_to(self, host: str, port: int) -> str:
        return self.send_request("connect", {"host": host, "port": port})

    @property
    def address(self) -> tuple[str, int]:
        return (self.config.effective_host(), self.port or 0)


class WorkerNode(BaseNode):
    """Offers device capacity; runs the DistributedWorker executor
    (reference Worker, nodes/nodes.py:256-301)."""

    CONFIG = WorkerConfig

    def start(self) -> "WorkerNode":
        if self._proc is None:
            # a worker with no card (MLConfig.device None) refuses here,
            # before its network process joins the mesh
            from tensorlink_tpu_torch.core.devices import resolve_device

            resolve_device(self.config.ml.device)
        return super().start()

    def _start_ml(self) -> None:
        from tensorlink_tpu_torch.ml.worker import DistributedWorker

        self.executor = DistributedWorker(self)
        self.send_request("set_capacity", self.executor.capacity())
        self._ml_thread = threading.Thread(
            target=self.executor.run, name="ml-worker", daemon=True
        )
        self._ml_thread.start()


class ValidatorNode(BaseNode):
    """Plans jobs, tracks workers, serves the HTTP API (reference Validator,
    nodes.py:304-377 + TensorlinkAPI, api/node.py:523-541)."""

    CONFIG = ValidatorConfig

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.api = None

    def _start_ml(self) -> None:
        from tensorlink_tpu_torch.ml.validator import DistributedValidator

        self.executor = DistributedValidator(self)
        self._ml_thread = threading.Thread(
            target=self.executor.run, name="ml-validator", daemon=True
        )
        self._ml_thread.start()
        if self.config.endpoint:
            from tensorlink_tpu_torch.api.server import TensorlinkAPI

            self.api = TensorlinkAPI(
                self,
                self.executor,
                host=self.config.endpoint_host,
                port=self.config.endpoint_port,
            ).start()

    def stop(self) -> None:
        if self.api is not None:
            self.api.stop()
            self.api = None
        super().stop()


class UserNode(BaseNode):
    """Requests models; the DistributedModel drives the job from the calling
    thread (reference User, nodes.py:380-414)."""

    CONFIG = UserConfig
