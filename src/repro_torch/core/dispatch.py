"""Dispatch policies — the scheduling vocabulary shared by the threaded
runtime and the discrete-event simulator (paper §5/§8).

TURNIP's runtime is free to launch *any* ready vertex ("at runtime, TURNIP
chooses the best order in response to real-time events"). *Which* ready
vertex it launches when an engine frees up is a policy decision, factored
out here so the threaded :class:`~repro_torch.core.runtime.TurnipRuntime` and the
:func:`~repro_torch.core.simulate.simulate` ablation rank candidates identically:

* ``random``         — uniform-random per-vertex priority (seeded); the
  stress-test policy: order-independence must hold for every draw;
* ``fixed``          — priority = compile-time simulation order (``seq``).
  Note this is *still* event-driven (a vertex launches only when ready);
  the head-of-line "fixed execution" ablation is the runtime's
  ``mode='fixed'``, not a priority policy;
* ``critical-path``  — longest cost-weighted path to a sink, computed from
  ``MemVertex.flops``/``nbytes``; vertices on the critical path launch
  first (classic list scheduling / HEFT upward rank);
* ``transfer-first`` — transfer-engine vertices (offload/reload/transfer/
  input) outrank compute, tie-broken by critical path: start DMAs as early
  as possible so they overlap under compute (the paper's "transfers never
  block computation" precondition).

This module also owns the *engine-class* model: each device has a compute
engine plus three DMA channels (host→device, device→host, device→device)
that run concurrently — the same structure as CUDA streams +
``cudaMemcpyAsync`` or TPU DMA engines. ``engine_of`` maps a vertex to the
engine class that executes it.
"""
from __future__ import annotations

import random
from typing import Callable, Iterable

from .memgraph import MemGraph, MemOp, MemVertex

__all__ = [
    "COMPUTE", "H2D", "D2H", "D2D", "DISK", "NIC", "ENGINE_KINDS",
    "TRANSFER_KINDS",
    "ENGINE_OF", "engine_of", "engine_key", "DispatchPolicy", "RandomPolicy",
    "FixedPolicy", "CriticalPathPolicy", "TransferFirstPolicy",
    "POLICY_NAMES", "get_policy",
]

# -- engine classes ---------------------------------------------------------
# `disk` is the I/O engine of the third storage tier (host RAM → disk): SPILL
# and LOAD vertices run there, so a two-hop reload's disk leg never occupies
# — or waits behind — the h2d/d2h DMA lanes.
# `nic` is the inter-replica link (ROADMAP item 1/2, arXiv 2502.15712's
# NIC-as-pipeline-resource): XFER vertices run there, so a KV migration's
# wire leg never competes with the local DMA or disk lanes. The plan
# builder never emits XFER — only simulator-built pricing graphs (see
# `simulate.price_migration`) and the serving router's cost model use it.
COMPUTE, H2D, D2H, D2D, DISK, NIC = \
    "compute", "h2d", "d2h", "d2d", "disk", "nic"
ENGINE_KINDS = (COMPUTE, H2D, D2H, D2D, DISK, NIC)
TRANSFER_KINDS = (H2D, D2H, D2D, DISK, NIC)

ENGINE_OF = {
    MemOp.INPUT: H2D,        # weights/activations stream in from host store
    MemOp.RELOAD: H2D,
    MemOp.OFFLOAD: D2H,
    MemOp.TRANSFER: D2D,
    MemOp.SPILL: DISK,       # host -> disk (second hop of a tiered eviction)
    MemOp.LOAD: DISK,        # disk -> host (first hop of a two-hop reload)
    MemOp.XFER: NIC,         # host -> remote host (inter-replica migration)
    MemOp.COMPUTE: COMPUTE,
    MemOp.ALLOC0: COMPUTE,
    MemOp.ADD_INTO: COMPUTE,
    MemOp.JOIN: COMPUTE,
}


def engine_of(v: MemVertex) -> str:
    """The engine class (compute or DMA direction) that executes ``v``."""
    return ENGINE_OF[v.op]


def engine_key(v: MemVertex) -> tuple[int, str]:
    """The (device, engine class) pair ``v`` is dispatched on — the unit
    of stream assignment shared by the simulator's engine model, the
    threaded runtime's ready heaps, and the compiled backend's
    fused-DMA adjacency rule (core/compile.py)."""
    return (v.device, ENGINE_OF[v.op])


# -- cost model for priority computation ------------------------------------
# Deliberately coarse (P100-ish constants): priorities only need the right
# *relative* ordering, and a policy must never affect results — only timing.
# These are the reference package's values, kept so that every policy ranks
# vertices exactly as the reference does. They are scheduling priorities,
# not measurements, and NOT H100 figures: the port's measured rates live in
# PERF.md.
_FLOPS = 8e12
_HBM_BW = 500e9
_DMA_BW = 12e9
_DISK_BW = 2.4e9          # NVMe-class: ~5x slower than the PCIe DMA lanes
_NIC_BW = 3.1e9           # 25 GbE-class inter-replica link
_KERNEL_OVERHEAD = 5e-6
_DMA_LATENCY = 10e-6
_DISK_LATENCY = 100e-6
_NIC_LATENCY = 50e-6


def vertex_cost(v: MemVertex) -> float:
    """Estimated execution seconds of ``v`` — the critical-path edge weight.

    Disk legs cost ~5x a DMA of the same size, so the cost-aware policies
    (critical-path / transfer-first) naturally rank a two-hop disk reload
    chain earlier than a one-hop host reload of equal size: the slowest
    tier is issued earliest."""
    if v.op == MemOp.JOIN:
        return 0.0
    if engine_of(v) == COMPUTE:
        return _KERNEL_OVERHEAD + max(v.flops / _FLOPS,
                                      3.0 * v.nbytes / _HBM_BW)
    if engine_of(v) == DISK:
        if v.nbytes == 0:       # a dedup/drop spill moves no bytes
            return 0.0
        return _DISK_LATENCY + v.nbytes / _DISK_BW
    if engine_of(v) == NIC:
        return _NIC_LATENCY + v.nbytes / _NIC_BW
    return _DMA_LATENCY + v.nbytes / _DMA_BW


def critical_path_lengths(
        mg: MemGraph,
        cost_fn: Callable[[MemVertex], float] = vertex_cost,
) -> dict[int, float]:
    """Longest cost-weighted path from each vertex to any sink (inclusive of
    the vertex's own cost) — the "upward rank" of list scheduling."""
    cp: dict[int, float] = {}
    for m in reversed(mg.topo_order()):
        tail = max((cp[s] for s in mg.succs[m]), default=0.0)
        cp[m] = cost_fn(mg.vertices[m]) + tail
    return cp


# -- policies ---------------------------------------------------------------
class DispatchPolicy:
    """Ranks ready vertices: lower :meth:`priority` launches first.

    ``prepare(mg)`` is called once per run before any ``priority`` query;
    priorities are static per (graph, policy) pair so both the threaded
    runtime's ready heaps and the simulator's event queue can use them as
    plain sort keys.
    """

    name = "base"

    def prepare(self, mg: MemGraph) -> None:
        self.mg = mg

    def priority(self, mid: int) -> float:
        raise NotImplementedError

    def order(self, mids: Iterable[int]) -> list[int]:
        """Convenience: rank ``mids`` best-first (stable on mid)."""
        return sorted(mids, key=lambda m: (self.priority(m), m))


class RandomPolicy(DispatchPolicy):
    """Uniform-random priority per vertex, deterministic given the seed and
    independent of arrival order (each vertex hashes its own stream).
    ``seed=None`` draws a fresh seed, so repeated unseeded runs stress
    *different* schedules — the paper's any-order-must-work stance."""

    name = "random"

    def __init__(self, seed: int | None = None) -> None:
        self.seed = random.randrange(2**31) if seed is None else seed

    def priority(self, mid: int) -> float:
        # salt differs from HardwareModel._jit's (seed << 20) ^ mid so a
        # simulation's dispatch draws and jitter draws are independent
        # streams even when both derive from the same seed.
        return random.Random((self.seed * 1000003 + 0x5BD1E995) ^ mid).random()


class FixedPolicy(DispatchPolicy):
    """Priority = compile-time simulation order (``MemVertex.seq``)."""

    name = "fixed"

    def priority(self, mid: int) -> float:
        return float(self.mg.vertices[mid].seq)


class CriticalPathPolicy(DispatchPolicy):
    """Longest-path-to-sink first; ties broken by ``seq``.

    ``cost_fn`` supplies per-vertex durations — pass the hardware model's
    (e.g. ``HardwareModel.duration``) so priorities reflect the machine
    being simulated; the default is the coarse built-in estimate.
    """

    name = "critical-path"

    def __init__(self, cost_fn: Callable[[MemVertex], float] | None = None
                 ) -> None:
        self.cost_fn = cost_fn or vertex_cost

    def prepare(self, mg: MemGraph) -> None:
        self.mg = mg
        self._cp = critical_path_lengths(mg, self.cost_fn)
        self._n = max(len(mg), 1)

    def priority(self, mid: int) -> float:
        # negative: larger critical path = earlier launch. The tiny seq
        # epsilon makes ties deterministic without masking the path length.
        return -self._cp[mid] + self.mg.vertices[mid].seq / (1e12 * self._n)


class TransferFirstPolicy(CriticalPathPolicy):
    """Vertices that perform — or directly feed — a DMA outrank the rest;
    critical path breaks ties within each bucket.

    Ready heaps are per engine class, so transfers never compete with
    compute for the same stream; what a policy *can* control is how soon a
    DMA's producer runs. Boosting compute vertices with a transfer
    successor starts offloads/reloads as early as possible: on real copy
    engines a transfer issued "too early" costs nothing (it runs on its own
    channel), while one issued late stalls its consumer (paper §2's
    unpredictable-transfer pathology).
    """

    name = "transfer-first"

    _BUCKET = 1e9   # >> any critical-path length in seconds

    def prepare(self, mg: MemGraph) -> None:
        super().prepare(mg)
        self._feeds_dma = {
            m: (engine_of(mg.vertices[m]) in TRANSFER_KINDS
                or any(engine_of(mg.vertices[s]) in TRANSFER_KINDS
                       for s in mg.succs[m]))
            for m in mg.vertices}

    def priority(self, mid: int) -> float:
        base = super().priority(mid)
        if self._feeds_dma[mid]:
            return base - self._BUCKET
        return base


POLICY_NAMES = ("random", "fixed", "critical-path", "transfer-first")


def get_policy(policy: str | DispatchPolicy | None, *,
               seed: int | None = None,
               cost_fn: Callable[[MemVertex], float] | None = None,
               ) -> DispatchPolicy:
    """Resolve a policy name (or pass through an instance). ``None`` means
    ``random`` — the paper's default stance that any order must work.
    ``cost_fn`` overrides the duration estimate of the cost-aware policies
    (ignored by ``random``/``fixed`` and by pre-built instances)."""
    if isinstance(policy, DispatchPolicy):
        return policy
    if policy is None or policy == "random":
        return RandomPolicy(seed)
    if policy == "fixed":
        return FixedPolicy()
    if policy == "critical-path":
        return CriticalPathPolicy(cost_fn)
    if policy == "transfer-first":
        return TransferFirstPolicy(cost_fn)
    raise ValueError(f"unknown dispatch policy {policy!r}; "
                     f"expected one of {POLICY_NAMES}")
