"""The fleet topology: N serving replicas behind one router.

The port of the fleet half of ``repro/launch/mesh.py``
(:class:`FleetTopology`, :func:`make_fleet_topology`), which
:class:`~repro_torch.serve.router.Router` consumes. The reference's device
mesh builders are XLA's and are not ported here (ROADMAP A13)."""
from __future__ import annotations

import dataclasses

__all__ = ["FleetTopology", "make_fleet_topology"]


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """N serving replicas behind one router.

    Each replica is an independent :class:`~repro_torch.serve.Engine` with
    its own host/disk tier population (``host_bytes_per_replica`` sizes a
    per-replica :class:`~repro_torch.core.pool.HostPool`; ``None`` =
    unpooled). The inter-replica link is priced with the constants of the
    simulator's NIC channel (``HardwareModel.nic_bw`` / ``nic_latency``):
    a link between hosts, not a device rate, so the defaults hold on any
    card."""

    n_replicas: int = 3
    host_bytes_per_replica: int | None = None
    nic_bw: float = 3.1e9            # 25 GbE-class
    nic_latency: float = 50e-6
    heartbeat_timeout_s: float = 2.0
    name_prefix: str = "replica"

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")

    @property
    def replica_names(self) -> tuple[str, ...]:
        return tuple(f"{self.name_prefix}-{i}"
                     for i in range(self.n_replicas))


def make_fleet_topology(n_replicas: int = 3, **kw) -> FleetTopology:
    """Convenience builder: ``FleetTopology(n_replicas, **kw)``."""
    return FleetTopology(n_replicas=n_replicas, **kw)
