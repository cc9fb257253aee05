"""BUILDMEMGRAPH — compile a TASKGRAPH into a MEMGRAPH (paper §6, Fig. 8/9).

The compiler performs a *simulated execution* of the TASKGRAPH over per-device
:class:`~repro_torch.core.policies.Arena` objects, maintaining two horizons through
the serialized vertex list ``V``:

* ``allocHzn`` — every vertex before it has an output location reserved. The
  compiler greedily pushes this as far ahead of ``execHzn`` as free memory
  allows, so the runtime gains freedom to reorder (paper §6);
* ``execHzn`` — every vertex before it has been "run" in simulation.

Four malloc/free variants (paper Fig. 9):

* ``simMalloc``       — free-space-only placement; on reuse of freed bytes it
  adds the safe-overwrite memory dependencies (readers of the previous writer
  → new writer);
* ``simMallocOffld``  — eviction placement: picks victims (Belady §C), emits
  ``victim → offload → reload`` chains, renames all future uses of the victim
  to its reload, adds ``offload → tenant`` plus executed-reader deps;
* ``simMallocForceReld`` — places an evicted input's reload right before its
  consumer runs (cannot fail short of a genuine OOM);
* ``simFree``         — returns an extent when its tensor's last consumer has
  executed in simulation.

Correctness (paper §7) holds by construction: every dependency edge is created
from an already-simulated vertex to a not-yet-simulated one, so the MEMGRAPH
is acyclic; and safe-overwrite edges are added for every byte of every reuse,
so it is race-free. Both properties are re-checked explicitly by the tests.

Beyond-paper extensions (flagged; documented in DESIGN.md §7):

* ``reuse_host_copy`` (default on) — re-evicting bytes that already exist in
  the host store (graph inputs; previously offloaded tensors) skips the
  redundant offload copy: tensors are immutable, so the first copy stays
  valid. ``False`` gives the paper-faithful always-offload behaviour.
* reservation *cancellation* — when eviction would otherwise have to victimize
  an unexecuted reservation (allocHzn ran ahead), the reservation is cancelled
  and re-made at execution time rather than "offloading" data that does not
  exist yet (which could deadlock the plan).
* terminal outputs evicted to host simply stay there (no orphan reload); the
  runtime serves results from the host store.
* bounded host tier (``host_capacity``; DESIGN.md §10) — host copies are
  tenants of a shared host :class:`~repro_torch.core.policies.Arena`; overflow
  spills the Belady-furthest copy to the disk tier (SPILL vertex on the
  disk engine) and reloads of disk-resident copies become pipelined
  two-hop LOAD→RELOAD chains. Dead host copies are dropped for free, and
  re-spilling bytes with a live disk twin moves nothing (the disk
  analogue of ``reuse_host_copy``). ``host_capacity=None`` (default)
  reproduces the paper's unbounded host store exactly.
* cross-tier prefetch (``prefetch_distance``; DESIGN.md §11) — the build
  runs twice when the host tier is bounded: pass 1 places reloads
  reactively and records the host-occupancy profile; a
  :class:`~repro_torch.core.policies.PrefetchPlan` walks that schedule backward
  to find, for every spilled copy, the earliest point its disk→host LOAD
  fits under ``host_capacity`` through every intervening window; pass 2
  emits the hoisted LOADs there (``MemVertex.prefetch``), turning
  force-reload stalls into pipelined transfers that run ahead of the
  consumer's horizon. Prefetch admissions use free space only — they can
  never force other copies out — so a skipped hint degrades to the
  reactive path, never to a worse plan.
* bounded disk tier (``disk_capacity``; DESIGN.md §11) — the disk rung is
  a budget too: the builder replays blob creation (first SPILL) and
  release (drop vertices — including for dead copies whose bytes already
  live on disk, which previously lingered) and raises
  :class:`MemgraphOOM` at compile time when the three-level footprint
  cannot fit. No plan that validates can overflow the disk at runtime.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable

from .analyze import Certificate, PlanCertificationError, certify
from .liveness import (LivenessCertificate, ProgressCertificationError,
                       certify_progress, default_pool_config)
from .memgraph import DepKind, Loc, MemGraph, MemOp
from .policies import (Arena, EvictionDecision, HostEntry, HostPlan,
                       PlacementDecision, PrefetchPlan, PrefetchRecord, INF)
from .taskgraph import OpKind, TaskGraph, TaskVertex

__all__ = ["BuildConfig", "BuildResult", "MemgraphOOM", "build_memgraph"]

_HOST_STORE = None  # sentinel: host source is the immutable input store


class MemgraphOOM(RuntimeError):
    """A single task's working set cannot fit in device memory."""


@dataclasses.dataclass
class BuildConfig:
    """Configuration for BUILDMEMGRAPH."""

    capacity: int | dict[int, int]              # arena size per device, units
    size_fn: Callable[[TaskVertex], int] | None = None  # default: out.nbytes
    reuse_host_copy: bool = True
    victim_policy: str = "belady"                # belady | lru | random  (§C)
    rng_seed: int = 0
    # host-tier budget (same units as `capacity`, shared by all devices).
    # None = unbounded CPU RAM (the paper's implicit assumption). Bounded,
    # the compiler spills Belady-chosen host copies to the disk tier
    # (SPILL vertices) and reloads them through two-hop LOAD→RELOAD
    # chains (DESIGN.md §10).
    host_capacity: int | None = None
    # shared-pool mode (DESIGN.md §12): a repro_torch.core.pool.Lease instead of
    # a private budget. The feasibility check charges the *leased share* —
    # the lease's inviolable floor (min_bytes; a floorless lease is
    # refused, its grant being revocable) — never the whole pool, so a
    # plan compiled under a lease stays feasible no matter how the
    # arbiter moves the other consumers' slack. host_capacity is ignored
    # when a lease is set (the lease IS the capacity request).
    host_lease: Any = None
    # disk-tier budget (same units). None = unbounded disk. Bounded, the
    # builder replays blob creation/release and raises MemgraphOOM at
    # compile time when the three-level footprint cannot fit (§11).
    disk_capacity: int | None = None
    # how many schedule positions ahead of a consumer a disk→host LOAD may
    # be hoisted (PrefetchPlan, §11). 0 disables prefetch and reproduces
    # the reactive force-reload placement exactly. Only meaningful when
    # host_capacity is bounded (otherwise nothing ever spills).
    prefetch_distance: int = 32
    # run the static plan-soundness certifier (DESIGN.md §13) over the
    # finished plan: prove race-freedom, tier coherence, and worst-case
    # budget feasibility for *every* legal execution order. A hazard on a
    # compiled plan is a compiler bug and raises PlanCertificationError.
    certify: bool = False
    # run the static liveness certifier (DESIGN.md §14) over the finished
    # plan: prove no legal execution order can stall under the plan's
    # implied pool model (the host_lease's actual pool population, or a
    # single private lease over host_capacity). A hazard raises
    # ProgressCertificationError carrying a stuck-state witness the
    # directed scheduler (runtime.replay_stall) can replay to a real
    # bounded-timeout stall.
    certify_liveness: bool = False
    # executor backend the runtime should use for this plan (DESIGN.md
    # §15). "interpreted" — the threaded event-driven scheduler for
    # every vertex (the paper's runtime). "compiled" — lower the plan to
    # a CompiledPlan (core/compile.py): certified-static regions run
    # straight-line with pre-resolved streams and fused DMA batches;
    # regions whose order legitimately depends on runtime transfer
    # completion fall back to the interpreter at marked seam vertices.
    backend: str = "interpreted"
    # seam-backend stamping bound (DESIGN.md §17): a compiled plan's
    # nondet region at most this long (and certified blocking-free) runs
    # on the thread-free inline executor instead of the threaded fleet.
    # None defers to compile.DEFAULT_SEAM_THRESHOLD.
    seam_threshold: int | None = None

    def size_of(self, v: TaskVertex) -> int:
        return (self.size_fn or (lambda u: u.out.nbytes))(v)

    def host_budget(self) -> int | None:
        """The host-tier units this plan may charge: the leased share
        under a pool, else the private ``host_capacity``.

        The leased share is the lease's *floor* (``min_bytes``) — the only
        number the arbiter guarantees for the plan's whole lifetime. A
        floorless lease is refused here: its grant is revocable, so a plan
        compiled against it could later hold more than the arbiter can
        honor and silently burst the pool bound (DESIGN.md §12)."""
        if self.host_lease is not None:
            if not self.host_lease.min_bytes:
                raise ValueError(
                    f"host_lease {self.host_lease.name!r} has no floor: "
                    "compile-time feasibility needs an inviolable share — "
                    "request the lease with min_bytes=<host budget>")
            return self.host_lease.min_bytes
        return self.host_capacity

    def cap_of(self, device: int) -> int:
        if isinstance(self.capacity, dict):
            return self.capacity[device]
        return self.capacity


@dataclasses.dataclass
class BuildResult:
    memgraph: MemGraph
    mid_of: dict[int, int]                      # taskgraph tid -> memgraph mid
    order: list[int]                            # serialized V (tids)
    peak_used: dict[int, int]                   # per device
    terminal_host: dict[int, int | None]        # outputs resting in host store
    n_offloads: int = 0
    n_reloads: int = 0
    n_cancelled: int = 0
    peak_host: int = 0                          # host-tier peak (units)
    n_spills: int = 0                           # host→disk spill vertices
    n_loads: int = 0                            # disk→host load vertices
    peak_disk: int = 0                          # disk-tier peak (units)
    n_prefetches: int = 0                       # LOADs hoisted ahead of use
    stall_bytes_hidden: int = 0                 # disk bytes moved off the
    #                                             consumers' critical path
    # ground-truth host-tier tenancies [key, admit_mid, release_mid|None,
    # units] from the HostPlan; the certifier recovers the same intervals
    # from the graph alone (tests cross-check the two)
    host_residencies: list[list[Any]] = dataclasses.field(
        default_factory=list)
    # soundness certificate (BuildConfig.certify; DESIGN.md §13)
    certificate: Certificate | None = None
    # liveness certificate (BuildConfig.certify_liveness; DESIGN.md §14)
    liveness_certificate: LivenessCertificate | None = None
    # executor backend requested by BuildConfig.backend (DESIGN.md §15);
    # TurnipRuntime.run() consults this to pick the compiled lowering
    # path over vertex-by-vertex interpretation
    backend: str = "interpreted"
    # inline-stamping bound carried from BuildConfig.seam_threshold
    # (DESIGN.md §17); None = compile.DEFAULT_SEAM_THRESHOLD
    seam_threshold: int | None = None

    def final_value_location(self, tid: int) -> tuple[str, int]:
        """Where the runtime finds a terminal output: ('host', mid-or-tid) or
        ('device', mid)."""
        if tid in self.terminal_host:
            ref = self.terminal_host[tid]
            return ("host", ref if ref is not None else tid)
        return ("device", self.mid_of[tid])


def build_memgraph(
    tg: TaskGraph,
    config: BuildConfig,
    order: list[int] | None = None,
) -> BuildResult:
    """Compile ``tg`` under ``config``. ``order`` is the serialized vertex
    list V (defaults to a topological order of ``tg``).

    With a bounded host tier and ``prefetch_distance > 0`` the build is
    two-pass: pass 1 places disk→host reloads reactively and records the
    host-occupancy profile; a :class:`~repro_torch.core.policies.PrefetchPlan`
    walks it backward to pick each reload's earliest feasible start; pass 2
    re-runs the simulation emitting the hoisted (``prefetch=True``) LOADs
    at those points. A plan with nothing to hoist returns pass 1 as-is."""
    if config.backend not in ("interpreted", "compiled"):
        raise ValueError(f"unknown executor backend {config.backend!r}; "
                         f"expected 'interpreted' or 'compiled'")
    builder = _Builder(tg, config, order)
    res = builder.run()
    if (config.host_budget() is not None and config.prefetch_distance > 0
            and builder.load_records):
        plan = PrefetchPlan(config.host_budget(), builder.occ_at,
                            config.prefetch_distance)
        hints = plan.compute(builder.load_records)
        if hints:
            try:
                res = _Builder(tg, config, order,
                               prefetch_hints=hints).run()
            except MemgraphOOM:
                # prefetch admissions shift later Belady choices, and a
                # shifted victim set can (rarely) need a blob the reactive
                # schedule never created — overflowing a tight disk budget
                # pass 1 satisfied. Prefetch is an optimization, not a
                # requirement: a program that compiles reactively must
                # always compile, so fall back to pass 1.
                pass
    if config.certify:
        res.certificate = certify(res.memgraph,
                                  host_capacity=config.host_budget(),
                                  disk_capacity=config.disk_capacity)
        if not res.certificate.ok:
            raise PlanCertificationError(res.certificate)
    if config.certify_liveness:
        res.liveness_certificate = certify_progress(
            res.memgraph,
            default_pool_config(config.host_budget(),
                                lease=config.host_lease),
            disk_capacity=config.disk_capacity)
        if not res.liveness_certificate.ok:
            raise ProgressCertificationError(res.liveness_certificate)
    res.backend = config.backend
    res.seam_threshold = config.seam_threshold
    return res


class _Builder:
    def __init__(self, tg: TaskGraph, config: BuildConfig,
                 order: list[int] | None,
                 prefetch_hints: dict[int, list[int]] | None = None) -> None:
        tg.validate()
        self.tg = tg
        self.cfg = config
        # default V = insertion order: a valid topological order by
        # construction (TaskGraph.add requires inputs to exist) that follows
        # natural program order — far better prefetch locality than an
        # arbitrary Kahn order.
        self.V = list(order) if order is not None else sorted(tg.vertices)
        if sorted(self.V) != sorted(tg.vertices):
            raise ValueError("order must be a permutation of the vertices")
        self.pos = {tid: i for i, tid in enumerate(self.V)}
        _check_order(tg, self.pos)

        self.mg = MemGraph()
        self.rng = random.Random(config.rng_seed)
        self.executed_mids: set[int] = set()
        self.arenas: dict[int, Arena] = {}
        for d in tg.devices():
            self.arenas[d] = Arena(d, config.cap_of(d))
            self.arenas[d].bind_executed_set(self.executed_mids)

        # consumer positions per tid, for Belady next-use and simFree
        self.cons_pos: dict[int, list[int]] = {
            t: sorted(self.pos[c] for c in tg.consumers(t)) for t in tg.vertices}
        self.cons_ptr: dict[int, int] = {t: 0 for t in tg.vertices}

        self.mid_of: dict[int, int] = {}         # tid -> primary mem vertex
        self.alias: dict[int, int] = {}           # tid -> mid of live value
        self.tid_of: dict[int, int] = {}          # mid -> tid (incl. reloads)
        self.evicted: set[int] = set()            # tids pending reload
        self.host_src: dict[int, int | None] = {}  # mid -> offload mid | None(=store)
        self.unallocated: set[int] = set()         # cancelled reservations (tids)
        self.terminal_host: dict[int, int | None] = {}
        # streaming-reduce groups: tid -> (alloc0_mid, join_mid)
        self.groups: dict[int, tuple[int, int]] = {}

        # the host tier: one CPU-RAM arena shared by all devices, with
        # Belady-over-the-schedule victim choice (DESIGN.md §10). Under a
        # pool (§12) the budget is the leased share, not the whole pool.
        self.hostplan = HostPlan(config.host_budget(), self._host_next_use)
        self.host_key_of: dict[int, int] = {}      # tid -> host-store key

        self.seq = 0
        self.n_offloads = self.n_reloads = self.n_cancelled = 0
        self.n_spills = self.n_loads = 0

        # ---- cross-tier prefetch + disk budget (DESIGN.md §11) ----------
        # execution windows: window w spans (completion of exec w-1,
        # completion of exec w]. Pass 1 records per-window max host
        # occupancy (occ_at) and every reactive LOAD (load_records) for
        # the PrefetchPlan; pass 2 consumes the resulting hints.
        self.prefetch_hints = prefetch_hints or {}
        self.exec_done = 0                      # current window index
        self.occ_at: list[int] = []             # per-window max occupancy
        self._win_max = 0
        self.load_records: list[PrefetchRecord] = []
        self.spill_window: dict[int, int] = {}  # SPILL mid -> window
        self.n_prefetches = 0
        self.stall_bytes_hidden = 0
        # disk-tier replay: blob units keyed by host key; first SPILL of a
        # key creates its blob, a drop vertex releases it
        self.disk_units = 0
        self.peak_disk = 0
        self.disk_size_of: dict[int, int] = {}
        # all-orders disk soundness (bounded cap only): every unit of a new
        # blob must be backed either by capacity never yet consumed
        # (_disk_free) or by a specific earlier drop, with a MEM dep on
        # that drop — the seq-order replay alone leaves a window where a
        # blob-creating SPILL overtakes the drop it was counting on
        # (certifier pass 3, DESIGN.md §13)
        self._disk_free = config.disk_capacity or 0
        self._disk_credits: list[list[int]] = []   # FIFO of [drop_mid, units]

    # ------------------------------------------------------------------ utils
    def _mark_executed(self, mid: int) -> None:
        self.mg.vertices[mid].seq = self.seq
        self.seq += 1
        self.executed_mids.add(mid)

    def next_use(self, mid: int) -> float:
        """Belady metric: position in V of the next simulated use of the
        tensor occupying ``mid``'s extent. An unexecuted reservation's next
        use is its own position (it still must run)."""
        tid = self.tid_of[mid]
        ptr = self.cons_ptr[tid]
        cp = self.cons_pos[tid]
        nxt: float = cp[ptr] if ptr < len(cp) else INF
        if mid not in self.executed_mids:
            nxt = min(nxt, self.pos[tid])
        return nxt

    def _arena(self, device: int) -> Arena:
        return self.arenas[device]

    # ----------------------------------------------- host tier (§10) utils
    def _host_next_use(self, e: HostEntry) -> float:
        """Belady metric for a host copy: the next position in V where the
        copy will be read back (i.e. the evicted tensor's next consumer).
        A copy whose tensor is device-resident or terminal has no known
        host-side use — it spills first."""
        if e.tid in self.evicted:
            cp, ptr = self.cons_pos[e.tid], self.cons_ptr[e.tid]
            if ptr < len(cp):
                return cp[ptr]
        return INF

    def _emit_spill(self, e: HostEntry, *, drop: bool = False) -> int:
        """SPILL vertex: evict host copy ``e`` to the disk tier (or, with
        ``drop``, release dead bytes). Re-spilling a copy that already has
        an immutable disk twin moves no bytes (nbytes=0) — the disk
        analogue of ``reuse_host_copy``. Ordered after the copy's producer
        and every emitted reader of the host bytes."""
        src = self.mg.vertices[e.producer]
        dedup = e.spill_src is not None
        tname = self.tg.vertices[e.tid].name or str(e.tid)
        smid = self.mg.add_vertex(
            MemOp.SPILL, src.device, src_tid=e.tid, loc=None,
            size=e.size, nbytes=0 if (drop or dedup) else e.nbytes,
            operands=[e.key], params={"drop": True} if drop else {},
            tier="disk", name=("drop:" if drop else "spill:") + tname)
        self.tid_of[smid] = e.tid
        self.mg.add_dep(e.producer, smid, DepKind.DATA)
        for r in e.readers:
            self.mg.add_dep(r, smid, DepKind.MEM)
        if drop:
            # the drop releases *every* copy of the bytes (host + disk
            # blob), so it must wait for anything that ever read them on
            # any tier: LOADs of the blob, readers of earlier residencies,
            # and the spill that retired the latest one — per-residency
            # deps alone leave a window where an old reader's read-through
            # races the blob's deletion
            for r in e.disk_readers | e.all_readers:
                self.mg.add_dep(r, smid, DepKind.MEM)
            if e.last_spill is not None:
                self.mg.add_dep(e.last_spill, smid, DepKind.MEM)
        self._mark_executed(smid)
        self.spill_window[smid] = self.exec_done
        if drop:
            self._disk_release(smid, self.disk_size_of.pop(e.key, 0))
        elif not dedup:
            self.n_spills += 1
            # annotate the originating offload: its payload continues to disk
            self.mg.vertices[e.key].tier = "disk"
            self._disk_admit(e.key, e.size, e.tid, smid)
        return smid

    def _disk_admit(self, key: int, size: int, tid: int, smid: int) -> None:
        """Charge a new blob against the disk budget (compile-time
        feasibility: the last tier has nowhere further to evict to), and —
        bounded — back every unit by unconsumed capacity or a specific
        earlier drop with a MEM dep ``drop → smid``, so *no* legal
        execution order can overflow the disk (not just the replayed one:
        without the dep a blob-creating SPILL may overtake the drop whose
        freed units the replay counted on)."""
        self.disk_size_of[key] = size
        self.disk_units += size
        self.peak_disk = max(self.peak_disk, self.disk_units)
        cap = self.cfg.disk_capacity
        if cap is None:
            return
        if self.disk_units > cap:
            raise MemgraphOOM(
                f"disk tier of {cap} units cannot hold the spilled working "
                f"set: {self.disk_units} units live after spilling task "
                f"{tid} — the three-level footprint does not fit "
                f"(host={self.cfg.host_budget()}, disk={cap})")
        need = size - min(self._disk_free, size)
        self._disk_free -= size - need
        while need > 0:
            # invariant: _disk_free + queued credits == cap - disk_units
            # (+ size here), so the queue covers `need` whenever the
            # feasibility check above passed
            drop_mid, units = self._disk_credits[0]
            take = min(units, need)
            self.mg.add_dep(drop_mid, smid, DepKind.MEM)
            need -= take
            if take == units:
                self._disk_credits.pop(0)
            else:
                self._disk_credits[0][1] = units - take

    def _disk_release(self, drop_mid: int, units: int) -> None:
        """Return a dropped blob's units to the budget as a credit tagged
        with the drop vertex, for later admissions to order after."""
        self.disk_units -= units
        if units and self.cfg.disk_capacity is not None:
            self._disk_credits.append([drop_mid, units])

    def _emit_disk_drop(self, e: HostEntry) -> int:
        """Release a dead, non-resident entry's disk blob: a zero-host-unit
        drop SPILL ordered after the blob's writer and every LOAD that read
        it, so the disk-tier units are reclaimed in any legal order (the
        blob used to linger until store close — an unbounded-disk hole)."""
        tname = self.tg.vertices[e.tid].name or str(e.tid)
        dmid = self.mg.add_vertex(
            MemOp.SPILL, self.mg.vertices[e.key].device, src_tid=e.tid,
            loc=None, size=0, nbytes=0, operands=[e.key],
            params={"drop": True}, tier="disk", name="drop:" + tname)
        self.tid_of[dmid] = e.tid
        self.mg.add_dep(e.spill_src, dmid, DepKind.DATA)
        # same total-ordering discipline as a resident drop: wait for every
        # reader of every residency and the spill that retired the last one
        for r in e.disk_readers | e.all_readers | e.readers:
            self.mg.add_dep(r, dmid, DepKind.MEM)
        if e.last_spill is not None:
            self.mg.add_dep(e.last_spill, dmid, DepKind.MEM)
        self._mark_executed(dmid)
        self._disk_release(dmid, self.disk_size_of.pop(e.key, 0))
        return dmid

    def _host_admit(self, producer_mid: int, key: int, tid: int,
                    size: int, nbytes: int,
                    exclude: frozenset = frozenset()) -> None:
        """Admit ``producer_mid``'s host copy into the host tier, emitting
        SPILL vertices for Belady victims and wiring the safe-overwrite MEM
        deps the producer must wait on."""
        deps = self.hostplan.admit(key, tid, size, nbytes, producer_mid,
                                   self.seq, spill_cb=self._emit_spill,
                                   exclude=exclude)
        if deps is None:
            raise MemgraphOOM(
                f"host tier of {self.cfg.host_budget()} units"
                f"{' (leased share)' if self.cfg.host_lease is not None else ''}"
                f" cannot stage {size} units for task {tid}")
        for d in deps:
            self.mg.add_dep(d, producer_mid, DepKind.MEM)
        self._win_max = max(self._win_max, self.hostplan.used_units)
        if self.hostplan.bounded:
            self.host_key_of[tid] = key

    def _drop_host_entry(self, e: HostEntry) -> None:
        """Release a dead host copy (and its disk twin, wherever it is)."""
        self.host_key_of.pop(e.tid, None)
        if e.resident:
            dmid = self._emit_spill(e, drop=True)
            self.hostplan.dropped(e, dmid, self.seq)
        else:
            if e.spill_src is not None:
                self._emit_disk_drop(e)
            self.hostplan.forget(e.key)

    # ------------------------------------- safe-overwrite deps (simMalloc)
    def _overwrite_deps(self, dec, tenant_mid: int) -> None:
        """Safe-overwrite: every reader of the bytes' previous writers must
        precede the new tenant (paper Fig. 9, simMalloc). ``direct_deps`` are
        ordering-only obligations (a pending offload of evicted bytes, the
        victim's executed readers) and get edges without reader expansion —
        expanding them would pull in *reload* vertices, which read the host
        copy, not the overwritten device bytes."""
        for w in dec.prev_writers:
            self.mg.add_dep(w, tenant_mid, DepKind.MEM)
            for r in self.mg.data_succs(w):
                self.mg.add_dep(r, tenant_mid, DepKind.MEM)
        for d in dec.direct_deps:
            self.mg.add_dep(d, tenant_mid, DepKind.MEM)

    # ------------------------------------------------------- allocation paths
    def _try_alloc(self, tid: int) -> bool:
        """simMalloc for the vertex at allocHzn: free space only."""
        v = self.tg.vertices[tid]
        size = self.cfg.size_of(v)
        arena = self._arena(v.device)
        if size > arena.capacity:
            raise MemgraphOOM(
                f"tensor of {size} units for task {tid} exceeds device "
                f"{v.device} capacity {arena.capacity}")
        dec = arena.place_free(size)
        if dec is None:
            return False
        self._commit_vertex(tid, arena, dec)
        return True

    def _alloc_offld(self, tid: int) -> None:
        """simMallocOffld: eviction placement; cannot fail short of OOM."""
        v = self.tg.vertices[tid]
        arena = self._arena(v.device)
        dec = self._evict_place(arena, self.cfg.size_of(v), f"output of {tid}")
        self._commit_vertex(tid, arena, dec)

    def _evict_place(self, arena: Arena, size: int, why: Any) -> PlacementDecision:
        evd = arena.place_evict(size, self.next_use,
                                victim_policy=self.cfg.victim_policy,
                                rng=self.rng)
        if evd is None:
            evd = arena.place_evict(size, self.next_use, allow_cancel=True,
                                    victim_policy=self.cfg.victim_policy,
                                    rng=self.rng)
        if evd is None:
            raise MemgraphOOM(
                f"device {arena.device}: cannot place {size} units for {why}; "
                f"capacity {arena.capacity}, pinned working set too large")
        extra = self._apply_eviction(arena, evd)
        dec = arena.evict_and_carve(evd, self.seq)
        dec.direct_deps |= extra   # ordering-only deps: no reader expansion
        return dec

    def _apply_eviction(self, arena: Arena, evd: EvictionDecision) -> set[int]:
        """Emit offload/reload chains for victims; cancel reservations.
        Returns extra mids the new tenant must wait on."""
        tenant_deps: set[int] = set()
        for mid in evd.victims:
            tenant_deps |= self._evict_one(arena.device, mid)
        for mid in evd.cancelled:
            tid = self.tid_of[mid]
            self.mg.vertices[mid].loc = None
            self.unallocated.add(tid)
            self.n_cancelled += 1
            # stale safe-overwrite deps on the reservation remain: they are
            # forward edges and merely conservative.
        return tenant_deps

    def _evict_one(self, device: int, victim_mid: int) -> set[int]:
        """victim → offload → reload chain (paper Fig. 9, simMallocOffld)."""
        vv = self.mg.vertices[victim_mid]
        tid = self.tid_of[victim_mid]
        deps: set[int] = {victim_mid}
        deps.update(self.mg.data_succs(victim_mid))  # readers-so-far

        have_host = (self.cfg.reuse_host_copy
                     and victim_mid in self.host_src)
        if have_host:
            off_mid = self.host_src[victim_mid]   # may be None (input store)
            if off_mid is not None:
                deps.add(off_mid)
        else:
            # a superseded host copy (reuse_host_copy=False re-offloads the
            # same tensor) is dead: release its host-tier extent first
            if self.hostplan.bounded:
                old_key = self.host_key_of.get(tid)
                if old_key is not None and old_key in self.hostplan.entries:
                    self._drop_host_entry(self.hostplan.entries[old_key])
            off_mid = self.mg.add_vertex(
                MemOp.OFFLOAD, device, src_tid=tid, loc=None,
                size=vv.size, nbytes=vv.nbytes, operands=[victim_mid],
                name=f"offload:{vv.name or tid}")
            self.tid_of[off_mid] = tid
            self.mg.add_dep(victim_mid, off_mid, DepKind.DATA)
            self._host_admit(off_mid, off_mid, tid, vv.size, vv.nbytes)
            self._mark_executed(off_mid)
            self.n_offloads += 1
            deps.add(off_mid)

        has_future = self.cons_ptr[tid] < len(self.cons_pos[tid])
        if not has_future:
            # terminal output: the host copy is its final resting place
            self.terminal_host[tid] = off_mid
            self.alias[tid] = off_mid if off_mid is not None else victim_mid
            self.evicted.discard(tid)
            return deps

        # rename all future uses of the victim to its reload
        rel_mid = self.mg.add_vertex(
            MemOp.RELOAD, device, src_tid=tid, loc=None,
            size=vv.size, nbytes=vv.nbytes,
            operands=[off_mid] if off_mid is not None else [],
            name=f"reload:{vv.name or tid}")
        self.tid_of[rel_mid] = tid
        if off_mid is not None:
            self.mg.add_dep(off_mid, rel_mid, DepKind.DATA)
        self.n_reloads += 1
        self.alias[tid] = rel_mid
        self.evicted.add(tid)
        self.host_src[rel_mid] = off_mid
        return deps

    def _commit_vertex(self, tid: int, arena: Arena,
                       dec: PlacementDecision) -> None:
        """Create (or re-place, if cancelled) the mem vertex for ``tid`` and
        bind its extent; wire safe-overwrite deps."""
        v = self.tg.vertices[tid]
        mid = self.mid_of.get(tid)
        loc = Loc(arena.device, dec.offset, dec.size)
        if mid is None:
            op = {OpKind.INPUT: MemOp.INPUT, OpKind.COMPUTE: MemOp.COMPUTE,
                  OpKind.TRANSFER: MemOp.TRANSFER,
                  OpKind.REDUCE: MemOp.COMPUTE}[v.kind]
            if v.kind == OpKind.REDUCE and v.streaming:
                op = MemOp.JOIN
            mid = self.mg.add_vertex(
                op, v.device, src_tid=tid, loc=loc, op_name=v.op,
                params=v.params, flops=v.flops, size=dec.size,
                nbytes=v.out.nbytes, name=v.name or str(tid))
            self.mid_of[tid] = mid
            self.tid_of[mid] = tid
            self.alias[tid] = mid
            if v.kind == OpKind.INPUT:
                self.host_src[mid] = _HOST_STORE  # input store holds it
        else:
            self.mg.vertices[mid].loc = loc
            self.unallocated.discard(tid)
        tenant = mid
        if v.kind == OpKind.REDUCE and v.streaming:
            # zero-init is the first writer; extent pinned until JOIN runs
            a0 = self.mg.add_vertex(
                MemOp.ALLOC0, v.device, src_tid=tid, loc=loc,
                op_name="zeros", size=dec.size, nbytes=v.out.nbytes,
                lock_group=loc.key, name=f"alloc0:{v.name or tid}")
            self.tid_of[a0] = tid
            self.mg.vertices[mid].lock_group = loc.key
            self.groups[tid] = (a0, mid)
            self._mark_executed(a0)
            self.mg.add_dep(a0, mid, DepKind.DATA)
            tenant = a0
        self._overwrite_deps(dec, tenant)
        arena.commit(dec, mid)
        if v.kind == OpKind.REDUCE and v.streaming:
            arena.pin(mid)

    # -------------------------------------------------- execution simulation
    def _advance_and_free(self, t: int, mypos: int) -> None:
        """simFree: advance ``t``'s consumer pointer past ``mypos``; free its
        extent once no future consumer remains."""
        cp, ptr = self.cons_pos[t], self.cons_ptr[t]
        while ptr < len(cp) and cp[ptr] <= mypos:
            ptr += 1
        self.cons_ptr[t] = ptr
        if (ptr >= len(cp) and t not in self.evicted
                and t not in self.terminal_host):
            m = self.alias[t]
            if self.mg.vertices[m].loc is not None:
                self._arena(self.mg.vertices[m].loc.device).free(m, self.seq)
            # any host/disk copy of a fully-consumed, non-terminal tensor
            # is dead: give its host-tier extent back (a zero-cost drop)
            if self.hostplan.bounded:
                key = self.host_key_of.get(t)
                if key is not None and key in self.hostplan.entries:
                    self._drop_host_entry(self.hostplan.entries[key])

    def _force_reload(self, tid: int) -> int:
        """simMallocForceReld: place the pending reload of ``tid``."""
        mid = self.alias[tid]
        vv = self.mg.vertices[mid]
        arena = self._arena(vv.device)
        dec = arena.place_free(vv.size)
        if dec is None:
            dec = self._evict_place(arena, vv.size, f"reload of {tid}")
        vv.loc = Loc(arena.device, dec.offset, dec.size)
        arena.commit(dec, mid)
        self._overwrite_deps(dec, mid)
        self._wire_host_source(mid, vv)
        self._mark_executed(mid)
        self.evicted.discard(tid)
        return mid

    def _wire_host_source(self, rel_mid: int, vv) -> None:
        """Bind a RELOAD to the tier currently holding its source copy.

        Host-resident: order after the copy's live producer (the OFFLOAD,
        or the latest LOAD that restaged it). Disk-resident: emit the
        pipelined two-hop chain — a LOAD (disk→host, on the disk engine)
        that restages the copy into the host arena (possibly spilling
        Belady victims to make room), then the RELOAD's h2d hop."""
        if not self.hostplan.bounded:
            return
        key = self.host_src.get(rel_mid)
        if key is None:                    # immutable input store: one hop
            return
        e = self.hostplan.entries.get(key)
        if e is None:                      # pragma: no cover — defensive
            return
        if e.resident:
            self.mg.add_dep(e.producer, rel_mid, DepKind.DATA)
            e.readers.add(rel_mid)
            if self.mg.vertices[e.producer].op == MemOp.LOAD:
                # the copy was restaged from disk (a prefetch LOAD): this
                # reload is the pipelined tail of a two-hop chain
                vv.tier = "disk"
            return
        tid = e.tid
        lmid = self.mg.add_vertex(
            MemOp.LOAD, vv.device, src_tid=tid, loc=None,
            size=e.size, nbytes=e.nbytes, operands=[key], tier="disk",
            name=f"load:{self.tg.vertices[tid].name or tid}")
        self.tid_of[lmid] = tid
        self.mg.add_dep(e.spill_src, lmid, DepKind.DATA)
        self.load_records.append(PrefetchRecord(
            tid=tid, size=e.size, nbytes=e.nbytes,
            spill_pos=self.spill_window.get(e.spill_src, 0),
            reload_pos=self.exec_done))
        self._host_admit(lmid, key, tid, e.size, e.nbytes,
                         exclude=frozenset({key}))
        self._mark_executed(lmid)
        self.n_loads += 1
        self.mg.add_dep(lmid, rel_mid, DepKind.DATA)
        vv.tier = "disk"
        self.hostplan.entries[key].readers.add(rel_mid)
        self.hostplan.entries[key].disk_readers.add(lmid)

    def _close_window(self) -> None:
        """One task finished simulating: seal its execution window's
        occupancy high-water mark (the PrefetchPlan's feasibility input)."""
        self._win_max = max(self._win_max, self.hostplan.used_units)
        self.occ_at.append(self._win_max)
        self.exec_done += 1
        self._win_max = self.hostplan.used_units

    def _try_prefetch(self, tid: int) -> None:
        """Pass-2 hint: restage ``tid``'s disk-resident host copy *now*,
        ahead of its consumer (a ``prefetch=True`` LOAD on the disk
        engine). Best-effort and free-space-only: if the entry is not
        actually spilled at this point (pass divergence) or no free host
        extent fits, the hint is dropped and the reactive force-reload
        path still covers the use — a skipped prefetch can only cost
        timing, never correctness."""
        key = self.host_key_of.get(tid)
        if key is None:
            return
        e = self.hostplan.entries.get(key)
        if e is None or e.resident or e.spill_src is None:
            return
        lmid = self.mg.add_vertex(
            MemOp.LOAD, self.mg.vertices[e.key].device, src_tid=tid,
            loc=None, size=e.size, nbytes=e.nbytes, operands=[key],
            tier="disk", prefetch=True,
            name=f"load:{self.tg.vertices[tid].name or tid}")
        deps = self.hostplan.admit(key, tid, e.size, e.nbytes, lmid,
                                   self.seq, spill_cb=self._emit_spill,
                                   exclude=frozenset({key}),
                                   allow_spill=False)
        if deps is None:                 # no free space here in pass 2
            self.mg.remove_vertex(lmid)
            return
        self.tid_of[lmid] = tid
        self.mg.add_dep(e.spill_src, lmid, DepKind.DATA)
        for d in deps:
            self.mg.add_dep(d, lmid, DepKind.MEM)
        e.disk_readers.add(lmid)
        self._mark_executed(lmid)
        self._win_max = max(self._win_max, self.hostplan.used_units)
        self.n_loads += 1
        self.n_prefetches += 1
        self.stall_bytes_hidden += e.nbytes
        if tid in self.evicted:
            # the pending RELOAD is now the pipelined tail of a two-hop
            # chain whose disk leg runs ahead of the consumer's horizon
            self.mg.vertices[self.alias[tid]].tier = "disk"

    def _execute(self, tid: int) -> None:
        v = self.tg.vertices[tid]
        vmid = self.mid_of.get(tid)
        pins: list[tuple[Arena, int]] = []

        def pin(arena: Arena, mid: int) -> None:
            arena.pin(mid)
            pins.append((arena, mid))

        try:
            # output extent: re-place if the reservation was cancelled
            if vmid is None or self.mg.vertices[vmid].loc is None:
                arena = self._arena(v.device)
                dec = arena.place_free(self.cfg.size_of(v))
                if dec is None:
                    dec = self._evict_place(arena, self.cfg.size_of(v),
                                            f"output of {tid}")
                self._commit_vertex(tid, arena, dec)
                vmid = self.mid_of[tid]
            out_arena = self._arena(v.device)
            streaming = v.kind == OpKind.REDUCE and v.streaming
            if not streaming:
                pin(out_arena, vmid)

            uniq_inputs = list(dict.fromkeys(v.inputs))
            mypos = self.pos[tid]
            if streaming:
                # §B: n partial sums stream into a locked accumulator one at
                # a time; each input is consumed — and its extent freed —
                # immediately, so at most one partial plus the accumulator
                # must be resident. This is what lets TURNIP "force them to
                # be run in sequence and offloaded" (paper §8).
                a0, join = self.groups[tid]
                loc = self.mg.vertices[join].loc
                join_ops: list[int] = []
                for t in uniq_inputs:
                    m = self._force_reload(t) if t in self.evicted else self.alias[t]
                    src_arena = self._arena(self.mg.vertices[m].loc.device)
                    src_arena.pin(m)
                    g = self.mg.add_vertex(
                        MemOp.ADD_INTO, v.device, src_tid=tid, loc=loc,
                        op_name="add_into", size=loc.size,
                        nbytes=v.out.nbytes, lock_group=loc.key,
                        operands=[m], name=f"add_into:{v.name or tid}")
                    self.tid_of[g] = tid
                    self.mg.add_dep(m, g, DepKind.DATA)
                    self.mg.add_dep(a0, g, DepKind.DATA)
                    self.mg.add_dep(g, join, DepKind.DATA)
                    self._mark_executed(g)
                    join_ops.append(g)
                    src_arena.unpin(m)
                    self._advance_and_free(t, mypos)
                self.mg.vertices[vmid].operands = join_ops
            else:
                resolved: dict[int, int] = {}
                for t in uniq_inputs:
                    m = self._force_reload(t) if t in self.evicted else self.alias[t]
                    resolved[t] = m
                    pin(self._arena(self.mg.vertices[m].loc.device), m)
                    self.mg.add_dep(m, vmid, DepKind.DATA)
                self.mg.vertices[vmid].operands = [resolved[t] for t in v.inputs]
        finally:
            for arena, mid in pins:
                arena.unpin(mid)

        # simFree: dead inputs give their extents back
        if not (v.kind == OpKind.REDUCE and v.streaming):
            for t in dict.fromkeys(v.inputs):
                self._advance_and_free(t, self.pos[tid])

        if v.kind == OpKind.REDUCE and v.streaming:
            out_arena.unpin(vmid)   # group pin taken at alloc time
        self._mark_executed(vmid)

    # ------------------------------------------- main loop (paper Fig. 8)
    def run(self) -> BuildResult:
        n = len(self.V)
        alloc_i = exec_i = 0
        while exec_i < n:
            if alloc_i < n and self._try_alloc(self.V[alloc_i]):
                alloc_i += 1            # allocated space for a future result
            elif alloc_i == exec_i:
                self._alloc_offld(self.V[alloc_i])  # must evict to proceed
                alloc_i += 1
            else:
                self._execute(self.V[exec_i])
                self._close_window()
                # the boundary after exec_i: emit the PrefetchPlan's
                # hoisted disk→host restages scheduled for this point
                for t in self.prefetch_hints.get(exec_i, ()):
                    self._try_prefetch(t)
                exec_i += 1
        return BuildResult(
            memgraph=self.mg,
            mid_of=dict(self.mid_of),
            order=list(self.V),
            peak_used={d: a.peak_used for d, a in self.arenas.items()},
            terminal_host=dict(self.terminal_host),
            n_offloads=self.n_offloads,
            n_reloads=self.n_reloads,
            n_cancelled=self.n_cancelled,
            peak_host=self.hostplan.peak_units,
            n_spills=self.n_spills,
            n_loads=self.n_loads,
            peak_disk=self.peak_disk,
            n_prefetches=self.n_prefetches,
            stall_bytes_hidden=self.stall_bytes_hidden,
            host_residencies=[list(r) for r in self.hostplan.residency_log],
        )


def _check_order(tg: TaskGraph, pos: dict[int, int]) -> None:
    for v in tg.vertices.values():
        for i in v.inputs:
            if pos[i] >= pos[v.tid]:
                raise ValueError(f"order violates dataflow: {i} !< {v.tid}")
