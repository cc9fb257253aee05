"""Static liveness certifier (DESIGN.md §14): prove no legal schedule can
stall the pool-arbitrated runtime.

The safety certifier (:mod:`~repro_torch.core.analyze`, §13) proves every
dependency-respecting execution order computes the right bytes; nothing
there proves every order *completes*. Since the shared host pool landed
(§12), completion is genuinely at risk: charge-before-submit lease
reservations, revocation drains routed through a consumer's own disk
stream, drop→spill capacity credits, bounded stream-class slots, and the
serving engine's all-or-nothing admission batches form a waits-for
structure that can circular-wait — and the only runtime guard was a
~10-second no-progress timer. This module replaces that band-aid with a
compile-time proof of deadlock freedom.

:func:`certify_progress` builds a **static blocking model** of the
runtime over a built :class:`~repro_torch.core.memgraph.MemGraph` plus a
:class:`PoolConfig` (the lease population, floors, disciplines, and
declared revocation-drain routes) and a :class:`StreamConfig` (bounded
stream-class slots), and proves that from every reachable (down-closed
prefix, pool/lease occupancy) configuration at least one vertex is
enabled. Four theorems, each with a typed hazard on refutation:

1. **Lease-guarantee feasibility** — the plan's worst-case simultaneous
   host occupancy (the max-weight antichain of residency intervals,
   reusing :func:`~repro_torch.core.analyze.max_weight_antichain` over the
   reachability bitsets) must fit the *guaranteed* share of the lease it
   charges: the inviolable floor, since any co-tenant's demand can revoke
   everything above it. An antichain exceeding the floor is a reachable
   configuration where a blocked admission waits on releases that are all
   its own descendants (``lease-floor-stall``).
2. **Disk-credit acyclicity** — a SPILL admitting a blob must, in at
   least one legal order, find its units free. If every blob that could
   free them has its drop *downstream* of the spill (the inverted image
   of the builder's drop→spill credit edges), every order stalls at the
   spill (``disk-credit-stall``).
3. **Revocation-drain acyclicity** — a revocation drain may only charge
   the leases its spec declares (``drains_via``); a cycle among draining
   leases is a configuration where each waits for room only the next can
   free (``revocation-cycle``). All-or-nothing admission batches larger
   than a lease's guaranteed share can refuse forever under revocation
   (``atomic-admission-stall``).
4. **Stream-slot sufficiency** — vertices that can block mid-admission
   under a reserving discipline must not be able to occupy every slot of
   a stream class that the unblocking releases also need
   (``stream-starvation``); the general residue is a cycle search over
   the resource-allocation graph (``waits-for-cycle``).

Every confirmable finding carries a **stuck-state witness**: a full
topological order plus a stall ``prefix`` and expected pool/lease
occupancy. The directed scheduler in :mod:`~repro_torch.core.runtime`
(:func:`~repro_torch.core.runtime.replay_stall`) replays the prefix against a
real :class:`~repro_torch.core.pool.HostPool` with the blocking admission
discipline and confirms an actual bounded-timeout stall — liveness
findings stay falsifiable the same way §13's race witnesses do.

The proof's runtime assumptions (:data:`ASSUMPTIONS`) are threaded
through ``pool.py``/``stores.py``/``runtime.py``/``serve/engine.py`` as
checked invariants: a blocking edge the model does not contain raises
:class:`LivenessModelError` — certifier unsoundness, surfaced loudly.

CLI: ``python -m repro_torch.core.liveness`` certifies progress for the seeded
example-plan corpus (the same distribution as the §13 gate) and exits
nonzero on any hazard; CI gates on it alongside the safety step.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Iterable, Mapping, Sequence

from .analyze import (PlanHazard, Residency, _witness_order,
                      max_weight_antichain, recover_residencies)
from .dispatch import COMPUTE, D2D, D2H, DISK, H2D
from .memgraph import MemGraph, MemOp, RaceError

__all__ = [
    "LeaseSpec", "PoolConfig", "StreamConfig", "LivenessCertificate",
    "ProgressCertificationError", "LivenessModelError", "certify_progress",
    "default_pool_config", "inline_seam_certified", "ASSUMPTIONS", "main",
]

# hazard kinds (PlanHazard.kind; witness_kind == "stall" when confirmable)
LEASE_FLOOR_STALL = "lease-floor-stall"
FLOORS_INFEASIBLE = "lease-floors-infeasible"
REVOCATION_CYCLE = "revocation-cycle"
ATOMIC_ADMISSION_STALL = "atomic-admission-stall"
DISK_CREDIT_STALL = "disk-credit-stall"
STREAM_STARVATION = "stream-starvation"
WAITS_FOR_CYCLE = "waits-for-cycle"
LIVENESS_STRUCTURE = "liveness-structure"

#: The runtime invariants the deadlock-freedom proof assumes. Each is
#: enforced as a checked invariant at the named seam; a violation raises
#: :class:`LivenessModelError` (certifier unsoundness), mirroring
#: ``runtime._certified_reraise`` for §13.
ASSUMPTIONS: tuple[str, ...] = (
    "A1 (stores.py/pool.py): a plan-driven occupancy lease never holds "
    "more than its certified guaranteed share — Lease.certified_floor is "
    "checked on every occupancy mirror.",
    "A2 (pool.py): a revocation drain only charges the leases declared "
    "in its spec's drains_via — HostPool.draining() marks the drain and "
    "try_charge rejects undeclared blocking edges.",
    "A3 (pool.py/lockcheck.py): revocation callbacks fire outside the "
    "pool lock and are non-blocking pressure signals; the lock-order "
    "sanitizer keeps the pool a leaf lock.",
    "A4 (serve/engine.py): the engine's no-progress detector is "
    "statically unreachable for a liveness-certified configuration — if "
    "it fires anyway it raises LivenessModelError with the live "
    "waits-for graph.",
)


class LivenessModelError(RaceError):
    """A blocking edge (or occupancy) outside the static model showed up
    at runtime: the liveness certifier is unsound or the runtime diverged
    from the plan/configuration it certified (DESIGN.md §14)."""


# --------------------------------------------------------------------------
# the static blocking model's inputs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeaseSpec:
    """One lease of the modeled pool.

    ``discipline`` names the charge style (DESIGN.md §12): ``"occupancy"``
    mirrors resident bytes unconditionally (a compiled plan — never blocks,
    but must stay within its certified floor, assumption A1);
    ``"reserving"`` charges before moving bytes and *blocks/defers* on
    refusal (the serving engine) — the discipline the stall replays use.

    ``drains_via`` declares every lease this lease's revocation drain may
    charge while freeing bytes (staging buffers, bounce pools). An
    undeclared drain charge at runtime violates assumption A2.
    ``drain_stream`` is the stream class the drain's writes ride.
    ``atomic_bytes`` is the largest all-or-nothing charge batch the
    consumer submits (the serve engine's swap-in/preemption sets)."""

    name: str
    min_bytes: int = 0
    weight: float = 1.0
    priority: int = 0
    discipline: str = "occupancy"
    drains_via: tuple[str, ...] = ()
    drain_stream: str = DISK
    atomic_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """The modeled :class:`~repro_torch.core.pool.HostPool`: capacity, lease
    population, arbitration policy, and which lease the plan's host tier
    charges (``plan_lease``)."""

    capacity: int
    leases: tuple[LeaseSpec, ...] = ()
    policy: str = "static"
    plan_lease: str | None = None

    def spec(self, name: str | None) -> LeaseSpec | None:
        for s in self.leases:
            if s.name == name:
                return s
        return None

    def guaranteed_bytes(self, name: str | None) -> int:
        """The share the arbiter can honor for the lease's whole lifetime
        under *any* co-tenant behavior: with co-tenants, the inviolable
        floor (everything above it is revocable slack); alone, the whole
        pool."""
        s = self.spec(name)
        if s is None:
            return 0
        if len(self.leases) <= 1:
            return self.capacity
        return s.min_bytes


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Bounded stream-class slots — the runtime's engine fleet
    (``TurnipRuntime(n_streams=, n_transfer_streams=)``)."""

    slots: Mapping[str, int]

    @staticmethod
    def default(n_streams: int = 5,
                n_transfer_streams: int = 1) -> "StreamConfig":
        return StreamConfig(slots={
            COMPUTE: n_streams, H2D: n_transfer_streams,
            D2H: n_transfer_streams, D2D: n_transfer_streams,
            DISK: n_transfer_streams})

    def slots_of(self, kind: str) -> int:
        return int(self.slots.get(kind, 1))


def default_pool_config(host_capacity: int | None, *,
                        lease: Any = None) -> PoolConfig | None:
    """The pool model a plain build implies: the compiled plan as the only
    consumer of its private host budget — or, when the build charged a
    real :class:`~repro_torch.core.pool.Lease`, the lease's actual pool
    population (co-tenants modeled as reserving consumers, the worst case
    for the plan's guarantee)."""
    if lease is not None:
        specs = []
        for l in lease.pool.leases():
            specs.append(LeaseSpec(
                name=l.name, min_bytes=l.min_bytes, weight=l.weight,
                priority=l.priority,
                discipline="occupancy" if l.name == lease.name
                else "reserving",
                drains_via=tuple(getattr(l, "drains_via", ()))))
        return PoolConfig(capacity=lease.pool.capacity,
                          leases=tuple(specs),
                          policy=getattr(lease.pool.policy, "name",
                                         "static"),
                          plan_lease=lease.name)
    if host_capacity is None:
        return None
    return PoolConfig(capacity=host_capacity,
                      leases=(LeaseSpec("memgraph",
                                        min_bytes=host_capacity),),
                      plan_lease="memgraph")


# --------------------------------------------------------------------------
# the certificate
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LivenessCertificate:
    """The liveness certifier's verdict over one (plan, pool, streams)
    configuration. ``worst_lease_units`` is the exact worst-case
    simultaneous host occupancy over all legal orders (max-weight
    antichain); ``guaranteed_units`` the share the arbiter can always
    honor; certification requires the first to fit the second."""

    ok: bool
    hazards: list[PlanHazard]
    n_vertices: int
    pool: PoolConfig | None = None
    streams: StreamConfig | None = None
    disk_capacity: int | None = None
    worst_lease_units: int = 0
    guaranteed_units: int | None = None
    n_blocking_edges: int = 0          # edges in the static waits-for graph
    n_spills_checked: int = 0          # disk admissions proven creditable

    def summary(self) -> str:
        head = "LIVE" if self.ok else f"{len(self.hazards)} hazard(s)"
        pool = (f"{len(self.pool.leases)} lease(s) over "
                f"{self.pool.capacity} B" if self.pool else "no pool")
        lines = [
            f"liveness certificate: {head} over {self.n_vertices} "
            f"vertices ({pool}, {self.n_blocking_edges} blocking edges, "
            f"{self.n_spills_checked} disk admissions)",
            f"  worst-case lease occupancy {self.worst_lease_units} units"
            + (f" / guaranteed {self.guaranteed_units}"
               if self.guaranteed_units is not None else " (unarbitrated)"),
        ]
        lines += [f"  {h}" for h in self.hazards]
        lines += [f"  assumes {a}" for a in ASSUMPTIONS]
        return "\n".join(lines)


class ProgressCertificationError(RaceError):
    """A configuration failed liveness certification: some legal schedule
    can stall the pool-arbitrated runtime (fail at compile time, not as a
    10-second timeout in production)."""

    def __init__(self, certificate: LivenessCertificate) -> None:
        super().__init__(certificate.summary())
        self.certificate = certificate


# --------------------------------------------------------------------------
# the certifier
# --------------------------------------------------------------------------
class _Progress:
    def __init__(self, mg: MemGraph, pool: PoolConfig | None,
                 streams: StreamConfig, disk_capacity: int | None,
                 max_hazards: int) -> None:
        self.mg = mg
        self.pool = pool
        self.streams = streams
        self.disk_capacity = disk_capacity
        self.max_hazards = max_hazards
        self.hazards: list[PlanHazard] = []
        self._seen: set[tuple[Any, ...]] = set()
        self.n_blocking_edges = 0
        self.n_spills_checked = 0
        self.worst_lease_units = 0
        self.guaranteed_units: int | None = None
        # per-class blocking-capable vertices (filled by the lease/disk
        # passes, consumed by the stream pass and the RAG search)
        self._blockers: dict[str, list[int]] = {}

    def full(self) -> bool:
        return len(self.hazards) >= self.max_hazards

    def emit(self, kind: str, vertices: tuple[int, ...], detail: str,
             **kw: Any) -> None:
        dedup = (kind,) + tuple(sorted(vertices)) + (kw.get("lease"),)
        if dedup in self._seen or self.full():
            return
        self._seen.add(dedup)
        self.hazards.append(PlanHazard(kind, vertices, detail, **kw))

    # ---- pool-structural checks (no graph needed) --------------------
    def pass_pool_structure(self) -> None:
        pool = self.pool
        if pool is None:
            return
        floors = sum(s.min_bytes for s in pool.leases)
        if floors > pool.capacity:
            self.emit(
                FLOORS_INFEASIBLE, (),
                f"lease floors sum to {floors} B over a {pool.capacity} B "
                f"pool — HostPool refuses the population at lease time, "
                f"so the configuration can never start",
                confirmable=False)
        for s in pool.leases:
            if s.discipline != "reserving" or s.atomic_bytes <= 0:
                continue
            guaranteed = pool.guaranteed_bytes(s.name)
            if s.atomic_bytes > guaranteed:
                self.emit(
                    ATOMIC_ADMISSION_STALL, (),
                    f"lease {s.name!r} submits all-or-nothing batches of "
                    f"{s.atomic_bytes} B but is guaranteed only "
                    f"{guaranteed} B: under full revocation the batch "
                    f"refuses forever and FIFO admission wedges behind it",
                    witness_kind="stall", lease=s.name,
                    expect_units=s.atomic_bytes, capacity=guaranteed)

    # ---- revocation-drain waits-for edges ----------------------------
    def _drain_edges(self) -> list[tuple[str, str]]:
        """lease→lease blocking edges: freeing ``a``'s bytes requires
        first charging ``b``. Only meaningful with co-tenants — a lone
        lease is never revoked."""
        pool = self.pool
        if pool is None or len(pool.leases) <= 1:
            return []
        edges = []
        for s in pool.leases:
            for tgt in s.drains_via:
                if pool.spec(tgt) is not None:
                    edges.append((s.name, tgt))
        return edges

    def pass_revocation_cycles(self) -> None:
        edges = self._drain_edges()
        self.n_blocking_edges += len(edges)
        graph: dict[str, list[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
        cyc = _find_cycle(graph)
        if cyc is not None:
            self.emit(
                REVOCATION_CYCLE, (),
                f"revocation drains form a waits-for cycle "
                f"{' -> '.join(cyc)}: once every lease on the cycle is in "
                f"overage, each can free bytes only by charging the next, "
                f"every charge is refused, and the pool is wedged",
                witness_kind="stall", lease=cyc[0],
                capacity=self.pool.capacity if self.pool else None)

    # ---- lease-guarantee feasibility over the plan -------------------
    def pass_lease_guarantee(
            self, host: list[Residency]) -> None:
        mg, pool = self.mg, self.pool
        if pool is None or pool.plan_lease is None:
            # no arbitration: the safety certifier's host_capacity bound
            # is the only budget story, and nothing can block on a lease
            return
        guaranteed = pool.guaranteed_bytes(pool.plan_lease)
        self.guaranteed_units = guaranteed
        if not host:
            return
        before = mg.happens_before
        prec = [(i, j)
                for i, ri in enumerate(host)
                for j, rj in enumerate(host)
                if i != j and ri.release is not None
                and before(ri.release, rj.admit)]
        weights = [r.units for r in host]
        worst, members = max_weight_antichain(weights, prec)
        self.worst_lease_units = worst
        if worst <= guaranteed:
            return
        admits = [host[i].admit for i in members]
        bitpos, desc = mg.reachability()
        abits = [bitpos[a] for a in admits]
        down = {m for m in mg.vertices
                if m in admits
                or any((desc[m] >> b) & 1 for b in abits)}
        order = tuple(mg.topo_order(
            key=lambda m: (0 if m in down else 1, mg.vertices[m].seq, m)))
        spec = pool.spec(pool.plan_lease)
        style = ("a blocked reserving admission waits on releases that "
                 "are all its own descendants"
                 if spec is not None and spec.discipline == "reserving"
                 else "the certified floor (assumption A1) is broken and "
                      "a reserving co-tenant blocks past its guarantee")
        self.emit(
            LEASE_FLOOR_STALL, tuple(admits),
            f"plan lease {pool.plan_lease!r} can be forced to hold "
            f"{worst} units simultaneously (admits {admits}) but the "
            f"arbiter guarantees only {guaranteed}: under full "
            f"revocation {style}",
            witness=order, witness_kind="stall", tier="host",
            prefix=len(down), expect_units=worst, capacity=guaranteed,
            lease=pool.plan_lease)
        stream = spec.drain_stream if spec is not None else DISK
        self._blockers.setdefault(D2H, []).extend(
            a for a in admits if mg.vertices[a].op == MemOp.OFFLOAD)
        self._blockers.setdefault(stream, []).extend(
            a for a in admits if mg.vertices[a].op == MemOp.LOAD)

    # ---- disk-credit acyclicity --------------------------------------
    def pass_disk_credits(self, disk: list[Residency]) -> None:
        """Every blob admission must find its units free in at least one
        legal order. ``must-live(s)`` — blobs admitted before ``s`` in
        *every* order whose drop can never precede ``s`` — is the part of
        the disk no schedule can clear first; if it plus ``s``'s own
        units exceeds the capacity, every order stalls at ``s``. This is
        the inverted image of the builder's drop→spill credit edges
        (``_disk_admit``): a credit edge pointing the wrong way makes the
        backing drop a descendant of the spill it should precede."""
        mg, cap = self.mg, self.disk_capacity
        if cap is None or not disk:
            return
        before = mg.happens_before
        for s in disk:
            self.n_spills_checked += 1
            must = [r for r in disk
                    if r is not s and before(r.admit, s.admit)
                    and (r.release is None
                         or before(s.admit, r.release))]
            held = sum(r.units for r in must)
            if held + s.units <= cap:
                continue
            order = _witness_order(mg, {s.admit}, set())
            prefix = order.index(s.admit)
            self.emit(
                DISK_CREDIT_STALL,
                (s.admit,) + tuple(r.admit for r in must),
                f"spill {s.admit} needs {s.units} unit(s) of disk but "
                f"blobs {[r.admit for r in must]} ({held} unit(s)) are "
                f"live before it in every order and every drop that "
                f"could free them is downstream of the spill — the "
                f"disk-credit FIFO waits on itself "
                f"({held}+{s.units} > capacity {cap})",
                witness=tuple(order), witness_kind="stall", tier="disk",
                prefix=prefix, expect_units=held + s.units, capacity=cap)
            self._blockers.setdefault(DISK, []).append(s.admit)
            if self.full():
                return

    # ---- stream-slot sufficiency + the RAG residue -------------------
    def pass_streams_and_rag(self) -> None:
        """The unifying cycle search over the resource-allocation graph:
        nodes are leases, stream classes, and the disk tier; an edge
        a → b means "freeing/advancing a can require b". The passes above
        are the cycles with a specific story; anything left is reported
        as a bare waits-for cycle."""
        mg, streams = self.mg, self.streams
        before = mg.happens_before
        # stream starvation: blockers of class k can hold every slot of k
        # while the releases that would unblock them also need class k
        for kind, blockers in sorted(self._blockers.items()):
            blockers = sorted(set(blockers))
            if not blockers:
                continue
            slots = streams.slots_of(kind)
            # pairwise-incomparable blockers are jointly schedulable: each
            # can sit blocked on its own slot at once
            incomp = _max_incomparable(blockers, before)
            if len(incomp) >= slots and kind == DISK:
                self.emit(
                    STREAM_STARVATION, tuple(incomp),
                    f"{len(incomp)} admissions that can block "
                    f"(vertices {incomp}) share the {slots}-slot "
                    f"{kind!r} stream class with the releases that would "
                    f"unblock them: once every slot holds a blocked "
                    f"admission no release can be issued",
                    confirmable=False, tier=kind)
        # the RAG residue
        graph: dict[str, list[str]] = {}
        pool = self.pool
        if pool is not None:
            for a, b in self._drain_edges():
                graph.setdefault(f"lease:{a}", []).append(f"lease:{b}")
            for s in pool.leases:
                if len(pool.leases) > 1:
                    # freeing a revoked lease's overage rides its drain
                    # stream
                    graph.setdefault(f"lease:{s.name}", []).append(
                        f"stream:{s.drain_stream}")
        for kind, blockers in self._blockers.items():
            if not blockers or pool is None:
                continue
            # a slot of `kind` can be held by a vertex blocked on the
            # plan lease (host admits) or the disk tier (spills)
            tgt = (f"lease:{pool.plan_lease}"
                   if pool.plan_lease is not None else None)
            if kind == DISK and self.disk_capacity is not None:
                graph.setdefault(f"stream:{kind}", []).append("disk")
                graph.setdefault("disk", []).append(f"stream:{DISK}")
            if tgt is not None and kind != DISK:
                graph.setdefault(f"stream:{kind}", []).append(tgt)
        self.n_blocking_edges += sum(len(v) for v in graph.values())
        cyc = _find_cycle(graph)
        if cyc is not None and not any(
                h.kind in (REVOCATION_CYCLE, STREAM_STARVATION,
                           DISK_CREDIT_STALL)
                for h in self.hazards):
            self.emit(
                WAITS_FOR_CYCLE, (),
                f"the static waits-for graph has a cycle "
                f"{' -> '.join(cyc)} not discharged by any specific "
                f"theorem — some configuration of blocked holders can "
                f"circular-wait",
                confirmable=False)


def _max_incomparable(vertices: Sequence[int],
                      before: Any) -> list[int]:
    """A maximal pairwise-incomparable subset (greedy — used only to
    compare against a slot count, where any witness set suffices)."""
    out: list[int] = []
    for v in vertices:
        if all(not before(v, u) and not before(u, v) for u in out):
            out.append(v)
    return out


def _find_cycle(graph: Mapping[str, Iterable[str]]) -> list[str] | None:
    """First cycle of a small digraph (3-color DFS), as a node list."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    stack: list[str] = []

    def visit(n: str) -> list[str] | None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            c = color.get(m, WHITE)
            if c == GRAY:
                return stack[stack.index(m):] + [m]
            if c == WHITE:
                cyc = visit(m)
                if cyc is not None:
                    return cyc
        color[n] = BLACK
        stack.pop()
        return None

    for n in sorted(graph):
        if color.get(n, WHITE) == WHITE:
            cyc = visit(n)
            if cyc is not None:
                return cyc
    return None


def certify_progress(mg: MemGraph, pool_config: PoolConfig | None = None,
                     stream_config: StreamConfig | None = None, *,
                     disk_capacity: int | None = None,
                     max_hazards: int = 64) -> LivenessCertificate:
    """Certify that no dependency-respecting execution order of ``mg``
    can stall under the modeled pool arbitration and stream fleet: from
    every reachable (down-closed prefix, pool occupancy) configuration at
    least one vertex is enabled."""
    streams = stream_config or StreamConfig.default()
    cert = LivenessCertificate(ok=True, hazards=[], n_vertices=len(mg),
                               pool=pool_config, streams=streams,
                               disk_capacity=disk_capacity)
    try:
        mg.topo_order()
    except RaceError:
        cert.ok = False
        cert.hazards.append(PlanHazard(
            LIVENESS_STRUCTURE, (),
            "MEMGRAPH contains a dependency cycle: the vertices on it "
            "are never enabled in any order", confirmable=False))
        return cert
    p = _Progress(mg, pool_config, streams, disk_capacity, max_hazards)
    p.hazards = cert.hazards
    p.pass_pool_structure()
    p.pass_revocation_cycles()
    host, disk = recover_residencies(mg)
    p.pass_lease_guarantee(host)
    p.pass_disk_credits(disk)
    p.pass_streams_and_rag()
    cert.worst_lease_units = p.worst_lease_units
    cert.guaranteed_units = p.guaranteed_units
    cert.n_blocking_edges = p.n_blocking_edges
    cert.n_spills_checked = p.n_spills_checked
    cert.ok = not cert.hazards
    return cert


# vertices whose execution charges a bounded admission gate (the pool's
# lease accounting or the disk tier's capacity) — the ops the blocking
# model prices as potential waits (§14's blocking edges)
_ADMISSION_OPS = (MemOp.OFFLOAD, MemOp.SPILL, MemOp.LOAD)


def inline_seam_certified(mg: MemGraph, mids: Sequence[int],
                          cert: LivenessCertificate | None) -> bool:
    """Is "no blocking waits on the calling thread" a *certified*
    property for the seam ``mids`` (DESIGN.md §17)?

    The inline executor runs a nondet seam on the calling thread, so a
    vertex that blocks mid-admission would stall the whole runtime loop
    — there is no other worker to free the resource it waits on. The
    claim is certified two ways:

    * the plan carries an ``ok`` liveness certificate: §14's blocking
      model already proved every pool/disk admission in the plan finds
      its bytes free in every legal order, which covers the calling
      thread as a degenerate one-worker schedule; or
    * the seam contains **no admission vertex at all** (no OFFLOAD /
      SPILL / LOAD member): vertices that never charge a bounded gate
      have no blocking edges in the model, vacuously.

    When neither holds, the compiler demotes the seam to the threaded
    backend, where a blocked admission only parks one worker stream.
    """
    if cert is not None and cert.ok:
        return True
    return not any(mg.vertices[m].op in _ADMISSION_OPS for m in mids)


# --------------------------------------------------------------------------
# CLI: liveness-certify the seeded example-plan corpus (CI gate)
# --------------------------------------------------------------------------
def main(argv: Sequence[str] | None = None) -> int:
    import random as pyrandom

    from .analyze import _corpus_taskgraph
    from .build import BuildConfig, MemgraphOOM, build_memgraph

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.liveness",
        description="Liveness-certify the seeded example-plan corpus: "
                    "every buildable plan must prove stall-free for all "
                    "execution orders under its implied pool model "
                    "(DESIGN.md §14).")
    p.add_argument("--seeds", type=int, default=24,
                   help="corpus size (default 24)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print one summary line per plan")
    args = p.parse_args(argv)

    host_caps = (None, 1, 2, 3)
    disk_caps = (None, 0, 2, 4, 50)
    n_live = n_oom = 0
    failed = 0
    for seed in range(args.seeds):
        rng = pyrandom.Random(1000 + seed)
        tg = _corpus_taskgraph(rng)
        host_cap = rng.choice(host_caps)
        disk_cap = rng.choice(disk_caps) if host_cap is not None else None
        cfg = BuildConfig(capacity=3, host_capacity=host_cap,
                          disk_capacity=disk_cap, rng_seed=seed,
                          size_fn=lambda v: 1)
        try:
            res = build_memgraph(tg, cfg)
        except MemgraphOOM:
            n_oom += 1
            if args.verbose:
                print(f"seed {seed}: rejected at compile time (OOM)")
            continue
        cert = certify_progress(
            res.memgraph, default_pool_config(host_cap),
            disk_capacity=disk_cap)
        if cert.ok:
            n_live += 1
            if args.verbose:
                g = cert.guaranteed_units
                print(f"seed {seed}: live "
                      f"(lease≤{cert.worst_lease_units}"
                      f"/{g if g is not None else '∞'}, "
                      f"{cert.n_spills_checked} disk admissions)")
        else:
            failed += 1
            print(f"seed {seed}: FAILED liveness certification")
            print(cert.summary())
    print(f"corpus: {n_live} plans certified live, {n_oom} rejected at "
          f"compile time, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
