"""Device meshes and the fleet topology: the port of ``repro/launch/mesh.py``.

:func:`make_production_mesh` and :func:`make_smoke_mesh` build
``DeviceMesh``es with the reference's shapes and axis names over an
initialised process group (``torch.distributed.init_process_group``; the
caller gives it its address, world size and rank). Functions, not
constants: importing this module touches no device state and imports
nothing of ``torch.distributed``.

The fleet half (:class:`FleetTopology`, :func:`make_fleet_topology`) is
what :class:`~repro_torch.serve.router.Router` consumes."""
from __future__ import annotations

import dataclasses

__all__ = ["FleetTopology", "make_fleet_topology", "make_production_mesh",
           "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple[int, ...] | None = None,
                         device_type: str = "cuda"):
    """16 x 16 = 256 devices a pod, axes ``('data', 'model')``; with
    ``multi_pod`` 2 x 16 x 16 = 512 with ``'pod'`` first. ``shape``
    overrides the per-pod (data, model) factorisation, e.g. (32, 8) for
    archs whose head counts divide 8 but not 16. The process group's world
    size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod and len(shape) == 2:
        shape = (2, *shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cuda"):
    """A one-device mesh with the production axis names: (1, 1) over
    ``('data', 'model')``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


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
