"""P2P substrate — asyncio TCP mesh with authenticated peers and a DHT.

Redesign of the reference's networking layer
(p2p/smart_node.py, p2p/connection.py, p2p/dht.py, p2p/monitor.py):

- One asyncio event loop per node instead of one thread per socket.
- Length-prefixed binary frames instead of sentinel-terminated chunk scans
  (reference connection.py:67 scans for ``EOT_CHAR``).
- Single listener socket; no handshake "port swap" (reference
  smart_node.py:786-955) — asyncio multiplexes connections natively.
- This package imports neither torch nor jax: the network process must
  stay free of device runtimes (same reason the reference keeps torch out
  of its networking process, nodes/nodes.py:139-147).
"""

from tensorlink_tpu_torch.p2p.connection import Connection
from tensorlink_tpu_torch.p2p.dht import DHT
from tensorlink_tpu_torch.p2p.monitor import RateLimiter
from tensorlink_tpu_torch.p2p.node import P2PNode

__all__ = ["Connection", "DHT", "RateLimiter", "P2PNode"]
