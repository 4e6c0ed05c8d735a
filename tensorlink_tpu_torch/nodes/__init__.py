"""Node runners and role servers.

The reference splits every node into a networking process and an ML process
bridged by ``mp.Queue`` pairs + a global lock polled at 1 kHz
(nodes/nodes.py:139-147, ml/worker.py:1349). The split survives here — the
network process must never import torch or jax, exactly as the reference
keeps torch out of it — but the bridge is event-driven: per-request futures
instead of a global ``mpc_lock``, blocking queue gets instead of poll loops.
"""

from tensorlink_tpu_torch.nodes.runners import UserNode, ValidatorNode, WorkerNode

__all__ = ["UserNode", "ValidatorNode", "WorkerNode"]
