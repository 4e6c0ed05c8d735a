"""Fleet serving: policy over N engine replicas of one model.

:mod:`tensorlink_tpu_torch.fleet.router` — per-request placement scored
on prefix-cache affinity, per-class queue depth / service EWMA, and
replica role/drain state.

:mod:`tensorlink_tpu_torch.fleet.prefixmap` — the fleet-wide prefix
digest map behind the tiered cache's fleet-pull rung.

:mod:`tensorlink_tpu_torch.fleet.autopilot` — the drain-driven control
loop: rebalance live streams off hot replicas, scale the decode pool,
and run zero-dropped-token rolling deploys through the migration
export/stage/adopt path.
"""

from tensorlink_tpu_torch.fleet.autopilot import (
    EngineFleetActions,
    FleetAutopilot,
)
from tensorlink_tpu_torch.fleet.prefixmap import FleetPrefixMap, make_fleet_fetcher
from tensorlink_tpu_torch.fleet.router import FleetRouter, NoReplicaAvailable

__all__ = [
    "EngineFleetActions",
    "FleetAutopilot",
    "FleetPrefixMap",
    "FleetRouter",
    "NoReplicaAvailable",
    "make_fleet_fetcher",
]
