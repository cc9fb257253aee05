"""The TURNIP execution engine (paper §5, §B), on the card.

Executes a compiled MEMGRAPH with a *nondeterministic, event-driven* loop:
whenever a vertex's dependencies are complete and an engine on its device is
free, it may be launched — in any order. Memory management is entirely
static: every vertex reads/writes the extents assigned at compile time
(paper §5).

Components:

* storage tiers — :mod:`~repro_torch.core.stores`: :class:`HostStore` (the
  pinned host arena, paper §B ``cudaHostAlloc``) and :class:`TieredStore`
  (bounded host RAM backed by a file-based disk tier, DESIGN.md §10).
  Plans whose compiler emitted SPILL/LOAD vertices automatically execute
  over a :class:`TieredStore`.
* memory backends — :class:`SlotTable` (validating: reads require the exact
  planned extent to hold live data, so *any* race or planning bug surfaces
  as a hard error) and :class:`ByteArena` (one preallocated ``uint8``
  buffer per logical device, on the run's device; extents are typed views
  of it, and ops write straight into them).
* :func:`run_in_order` — single-threaded reference interpreter executing an
  arbitrary caller-supplied topological order.
* :func:`eval_taskgraph` — direct dataflow evaluation with no plan: the
  oracle every run is held against.
* :class:`TurnipRuntime` — a facade over the executor core
  (:mod:`~repro_torch.core.executor`) with two executor backends. The
  interpreted one runs the whole graph on the threaded engine-stream
  fleet, completion taken from CUDA events. The compiled one
  (``exec_backend='compiled'``, or ``BuildConfig(backend='compiled')``)
  lowers the plan (:func:`~repro_torch.core.compile.lower`) and issues
  its certified-STATIC regions straight-line on CUDA streams with no host
  wait per vertex (:class:`~repro_torch.core.executor.StaticExecutor`),
  handing each nondet region to the inline executor or the fleet. Ready
  vertices are ranked by a pluggable
  :class:`~repro_torch.core.dispatch.DispatchPolicy`; ``mode='fixed'``
  reproduces the paper's ablation: vertices are *issued* strictly in the
  compile-time simulation order (head-of-line blocking), though still
  asynchronous once issued.
* :func:`replay_stall` — the directed stuck-state scheduler that turns a
  liveness certificate's witness (DESIGN.md §14) into an observed,
  bounded-timeout stall against a real :class:`~repro_torch.core.pool.HostPool`.

Every entry point runs on CUDA unless ``device='cpu'`` is passed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from . import liveness as _lv
from .bridge import host_tensor
from .build import BuildResult
from .device import resolve_device
from .dispatch import (COMPUTE, DispatchPolicy, TRANSFER_KINDS, engine_of,
                       get_policy)
from .executor import (INLINE, THREADED, ExecContext, InlineExecutor,
                       StaticExecutor, ThreadedExecutor, _exec_vertex)
from .memgraph import Loc, MemGraph, MemOp, MemVertex, RaceError
from .ops import get_op
from .pool import HostPool, Lease
from .stores import DiskStore, HostStore, TieredStore
from .taskgraph import OpKind, TaskGraph, TensorSpec

__all__ = ["HostStore", "DiskStore", "TieredStore", "SlotTable", "ByteArena",
           "run_in_order", "eval_taskgraph", "TurnipRuntime", "RunResult",
           "make_store", "replay_stall"]


def make_store(mg: MemGraph, inputs: dict[int, Any], *, device=None,
               lease=None) -> HostStore:
    """The store a plan needs: a plain :class:`HostStore`, or — when the
    compiler emitted disk-tier SPILL/LOAD vertices — a :class:`TieredStore`
    whose spills actually hit files. The caller owns ``close()``.

    ``lease``: a :class:`~repro_torch.core.pool.Lease` when the plan's host
    copies live in a shared arbitrated pool (DESIGN.md §12) — occupancy
    is mirrored into the lease so the arbiter sees this consumer's
    pressure. A leased store is always tiered (even for plans with no
    disk vertices) so occupancy accounting rides the same hooks."""
    if lease is not None or any(v.op in (MemOp.SPILL, MemOp.LOAD)
                                for v in mg.vertices.values()):
        # capacity enforcement lives in the plan (auto_spill off): the
        # SPILL/LOAD vertices are the Belady-chosen tier traffic
        return TieredStore(inputs, device=device, auto_spill=False,
                           lease=lease)
    return HostStore(inputs, device=device)


# --------------------------------------------------------------------------
# memory backends
# --------------------------------------------------------------------------
class SlotTable:
    """Validating memory model: an extent holds a value only between a write
    and the next overlapping write. Reading a missing/clobbered extent raises
    :class:`RaceError` — this is how the tests prove race-freedom. Values
    are tensors of their own on ``device``; ops never write into them. On
    CUDA a read records the reading stream on the value, so the caching
    allocator does not hand its memory out again, when a later write
    replaces it, before that stream's reads have finished (the compiled
    backend does not wait for them on the host)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._mem: dict[int, dict[tuple[int, int], torch.Tensor]] = {}
        self._lock = threading.Lock()

    def dest(self, loc: Loc, spec: TensorSpec) -> None:
        """No extent to write into: ops return fresh tensors."""
        return None

    def write(self, loc: Loc, value: torch.Tensor) -> None:
        value = value.to(self.device, non_blocking=True)
        with self._lock:
            dev = self._mem.setdefault(loc.device, {})
            span = (loc.offset, loc.size)
            for (o, s) in list(dev):
                if o < loc.offset + loc.size and loc.offset < o + s \
                        and (o, s) != span:
                    del dev[(o, s)]
            dev[span] = value

    def read(self, loc: Loc) -> torch.Tensor:
        with self._lock:
            dev = self._mem.get(loc.device, {})
            try:
                value = dev[(loc.offset, loc.size)]
            except KeyError:
                raise RaceError(
                    f"read of dead/clobbered extent {loc} — racy order or "
                    f"bad memory plan") from None
        if value.is_cuda:
            value.record_stream(torch.cuda.current_stream(value.device))
        return value

    def zero(self, loc: Loc, spec: TensorSpec) -> None:
        self.write(loc, torch.zeros(spec.shape, dtype=spec.torch_dtype,
                                    device=self.device))

    def add_into(self, loc: Loc, value: torch.Tensor) -> None:
        self.write(loc, self.read(loc) + value)

    def drop(self, loc: Loc) -> None:
        with self._lock:
            self._mem.get(loc.device, {}).pop((loc.offset, loc.size), None)


class ByteArena:
    """Real static placement: one preallocated ``uint8`` buffer per logical
    device, all on ``device`` (on one GPU the logical devices of a
    multi-device plan are disjoint buffers in its HBM, and d2d is a copy
    inside HBM). Extents are byte ranges (the MEMGRAPH must be built with
    byte sizes) read as typed views: :meth:`read` returns a view, not a
    copy, and :meth:`dest` gives an op the view to write its result into.
    ``.view(dtype)`` needs an extent's offset to be a multiple of the
    element size, which byte-sized plans of one dtype satisfy."""

    def __init__(self, capacities: dict[int, int], device=None) -> None:
        self.device = resolve_device(device)
        self.bufs = {d: torch.empty(c, dtype=torch.uint8, device=self.device)
                     for d, c in capacities.items()}
        self.specs: dict[tuple[int, int, int], tuple] = {}
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return sum(b.numel() for b in self.bufs.values())

    def _view(self, loc: Loc, shape, dtype: torch.dtype) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= s
        nbytes = n * dtype.itemsize
        if nbytes > loc.size:
            raise RaceError(f"value of {nbytes}B exceeds extent {loc}")
        raw = self.bufs[loc.device][loc.offset:loc.offset + nbytes]
        return raw.view(dtype).view(tuple(shape))

    def dest(self, loc: Loc, spec: TensorSpec) -> torch.Tensor:
        """The typed view of ``loc`` an op writes its result into."""
        return self._view(loc, spec.shape, spec.torch_dtype)

    def write(self, loc: Loc, value: torch.Tensor) -> None:
        view = self._view(loc, value.shape, value.dtype)
        if view.data_ptr() != value.data_ptr() or view.device != value.device:
            view.copy_(value, non_blocking=True)   # h2d from pinned host
        # buffer bytes and spec must move together: a reader holding the lock
        # must never see a new spec over stale bytes (or vice versa).
        with self._lock:
            self.specs[(loc.device, loc.offset, loc.size)] = \
                (tuple(value.shape), value.dtype)

    def read(self, loc: Loc) -> torch.Tensor:
        with self._lock:
            try:
                shape, dtype = self.specs[(loc.device, loc.offset, loc.size)]
            except KeyError:
                raise RaceError(
                    f"read of unwritten/dropped extent {loc} — racy order "
                    f"or bad memory plan") from None
        return self._view(loc, shape, dtype)

    def zero(self, loc: Loc, spec: TensorSpec) -> None:
        self.write(loc, self.dest(loc, spec).zero_())

    def add_into(self, loc: Loc, value: torch.Tensor) -> None:
        acc = self.read(loc)
        acc.add_(value)                      # in place, inside the extent
        self.write(loc, acc)

    def drop(self, loc: Loc) -> None:
        # Invalidating the spec makes ByteArena match SlotTable's
        # read-validation contract (reads of dead extents raise
        # RaceError); the bytes themselves stay in the arena, as on real
        # hardware.
        with self._lock:
            self.specs.pop((loc.device, loc.offset, loc.size), None)


def _collect_outputs(tg: TaskGraph, res: BuildResult, mem,
                     host: HostStore) -> dict[int, torch.Tensor]:
    outs: dict[int, torch.Tensor] = {}
    for tid in tg.vertices:
        if not tg.consumers(tid):
            kind, ref = res.final_value_location(tid)
            if kind == "host":
                # peek reads through every tier (a terminal output may have
                # been spilled to disk) without counting reload traffic
                val = host.peek_offload(ref)
                outs[tid] = val if val is not None else host.inputs[tid]
            else:
                # a copy: the extent belongs to the arena, not the caller
                outs[tid] = mem.read(res.memgraph.vertices[ref].loc).clone()
    return outs


def eval_taskgraph(tg: TaskGraph, inputs: dict[int, Any], *, device=None,
                   plain: bool = False) -> dict[int, torch.Tensor]:
    """Direct dataflow evaluation of a TASKGRAPH (no memory plan) on
    ``device`` (default CUDA) — the ground-truth oracle the MEMGRAPH runtime
    must match in any order. ``plain=True`` evaluates every op that has a
    hand-written kernel by its plain torch version instead."""
    dev = resolve_device(device)
    vals: dict[int, torch.Tensor] = {}
    for tid in tg.topo_order():
        v = tg.vertices[tid]
        if v.kind == OpKind.INPUT:
            vals[tid] = host_tensor(inputs[tid], pin=False).to(dev)
        elif v.kind == OpKind.TRANSFER:
            vals[tid] = vals[v.inputs[0]]
        elif v.kind == OpKind.REDUCE:
            out = vals[v.inputs[0]]
            for i in v.inputs[1:]:
                out = out + vals[i]
            vals[tid] = out
        else:
            vals[tid] = get_op(v.op, plain=plain)(
                *[vals[i] for i in v.inputs], **v.params)
    return {t: vals[t] for t in tg.vertices if not tg.consumers(t)}


def run_in_order(tg: TaskGraph, res: BuildResult,
                 inputs: dict[int, Any],
                 order: list[int] | None = None, *,
                 device=None) -> dict[int, torch.Tensor]:
    """Reference interpreter: execute ``order`` (any topological order of the
    MEMGRAPH; defaults to the compile-time simulation order) sequentially on
    ``device`` (default CUDA). Raises :class:`RaceError` if the order
    violates the plan's memory safety — which, for orders respecting the
    dependencies, must never happen."""
    dev = resolve_device(device)
    mg = res.memgraph
    if order is None:
        order = sorted(mg.vertices, key=lambda m: mg.vertices[m].seq)
    done: set[int] = set()
    for m in order:
        if any(p not in done for p in mg.preds[m]):
            raise ValueError(f"order is not topological at vertex {m}")
        done.add(m)
    host = make_store(mg, inputs, device=dev)
    try:
        mem = SlotTable(dev)
        for m in order:
            try:
                _exec_vertex(mg.vertices[m], mg, tg, mem, host)
            except RaceError as e:
                _certified_reraise(res, e)
        return _collect_outputs(tg, res, mem, host)
    finally:
        host.close()


def _certified_reraise(res: BuildResult, err: RaceError) -> None:
    """Debug hook (DESIGN.md §13): a plan the certifier proved clean must
    never race at runtime — if one does, either the certifier is unsound
    or an executor diverged from the plan. Surface that loudly instead of
    letting it read like an ordinary plan bug."""
    cert = getattr(res, "certificate", None)
    if cert is not None and getattr(cert, "ok", False):
        raise RaceError(
            f"{err} [plan was certified clean for ALL execution orders: "
            f"this RaceError means the certifier is unsound or the "
            f"runtime diverged from the plan — DESIGN.md §13]") from err
    raise err


# --------------------------------------------------------------------------
# threaded, event-driven runtime
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RunResult:
    """One run's outputs and measurements. ``timeline``, ``spans``,
    ``busy``, ``stall`` and ``transfer_time`` are host time (seconds since
    the run's start): a vertex's span runs from its pick until the host
    knew it complete (for the static walker: until its launches
    returned; :mod:`~repro_torch.core.executor` says what a span holds).
    On CUDA they hold the host's issue time as well as the card's work,
    so ``busy`` is not the card's busy time: a profiler's kernel
    intervals are. ``stall`` is the makespan less ``busy``;
    ``launch_time`` is the part of the spans spent launching."""

    outputs: dict[int, torch.Tensor]
    makespan: float                      # host clock, start to last sync
    busy: dict[int, float]               # per device: compute-engine seconds
    stall: dict[int, float]              # makespan - busy (per device)
    transfer_time: dict[str, float]      # per DMA/disk channel: busy seconds
    offload_bytes: int
    reload_bytes: int
    timeline: list[tuple[float, float, int, str, str]]  # t0,t1,dev,engine,name
    spans: dict[int, tuple[float, float]]  # mid -> (start, end), as timeline
    disk_spill_bytes: int = 0            # host→disk tier traffic
    disk_load_bytes: int = 0             # disk→host tier traffic
    peak_host_bytes: int = 0             # host-tier occupancy high-water mark
    arena_bytes: int = 0                 # ByteArena buffers (0 for slots)
    arena_device: str | None = None      # where the ByteArena lived
    # per engine class: host seconds spent launching vertices, the part of
    # the spans that is not waiting for the card
    launch_time: dict[str, float] = dataclasses.field(default_factory=dict)
    # compiled-backend counters (DESIGN.md §15): vertices executed by the
    # straight-line compiled program vs handed to the interpreter at
    # nondet-region seams, and fused DMA submissions issued. All zero
    # under the interpreted backend except n_interpreted = |V|.
    n_compiled: int = 0
    n_interpreted: int = 0
    fused_dma_batches: int = 0
    # seam-backend split (DESIGN.md §17): of the interpreted vertices,
    # how many ran on the thread-free inline executor vs the threaded
    # fleet. Invariant: n_inline + n_threaded == n_interpreted.
    n_inline: int = 0
    n_threaded: int = 0


def _union(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``intervals``."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


class TurnipRuntime:
    """Event-driven nondeterministic executor (paper §5/§B) on CUDA streams.

    ``mode='nondet'`` — any ready vertex may launch on any free stream of its
    engine class (the paper's design); the *choice* among ready vertices is
    delegated to a :class:`~repro_torch.core.dispatch.DispatchPolicy`
    (``policy``: ``random`` | ``fixed`` | ``critical-path`` |
    ``transfer-first`` or an instance). ``mode='fixed'`` — the ablation:
    vertices are issued in the compile-time simulation order with
    head-of-line blocking (still asynchronous once issued, matching the
    paper's "mostly removed" nondeterminism).

    Each device runs ``n_streams`` compute streams (paper: 5 CUDA streams
    per GPU) plus ``n_transfer_streams`` dedicated DMA streams for each of
    h2d/d2h/d2d — so transfers never occupy, nor wait behind, a compute
    stream. A vertex is complete when its CUDA event has fired
    (:mod:`~repro_torch.core.executor`).

    ``device`` — where the run executes (default CUDA; ``'cpu'`` runs the
    same scheduler with plain torch ops and no streams). ``backend`` —
    the memory backend: ``'slots'`` (:class:`SlotTable`) or ``'bytes'``
    (:class:`ByteArena`, which needs ``capacities`` in bytes per logical
    device).

    ``exec_backend`` — ``'interpreted'`` or ``'compiled'`` (default: the
    plan's ``BuildConfig.backend``); ``seam_backend`` — which executor runs
    a compiled plan's nondet regions: ``'auto'`` (the compiler's stamp),
    ``'inline'`` or ``'threaded'``.

    ``latency`` — optional ``fn(vertex) -> seconds`` injected as a sleep
    before the op runs; it occupies the vertex's stream for that long.

    ``store_factory`` — optional ``fn(inputs) -> HostStore``; by default the
    runtime builds the store the plan needs (:func:`make_store`): a
    :class:`TieredStore` whenever the compiled plan contains disk-tier
    SPILL/LOAD vertices. Caller-supplied stores are not closed by the
    runtime.
    """

    def __init__(self, tg: TaskGraph, res: BuildResult, *,
                 n_streams: int = 5, n_transfer_streams: int = 1,
                 mode: str = "nondet",
                 policy: str | DispatchPolicy | None = None,
                 latency: Callable[[MemVertex], float] | None = None,
                 backend: str = "slots",
                 capacities: dict[int, int] | None = None,
                 store_factory: Callable[[dict], HostStore] | None = None,
                 host_lease=None,
                 seed: int | None = None,
                 exec_backend: str | None = None,
                 seam_backend: str = "auto",
                 device: str | torch.device | None = None) -> None:
        if mode not in ("nondet", "fixed"):
            raise ValueError(mode)
        if backend not in ("slots", "bytes"):
            raise ValueError(f"unknown memory backend {backend!r}")
        if seam_backend not in ("auto", INLINE, THREADED):
            raise ValueError(f"unknown seam backend {seam_backend!r}")
        if host_lease is not None and store_factory is not None:
            raise ValueError("pass host_lease OR store_factory, not both "
                             "(attach the lease inside the factory instead)")
        self.device = resolve_device(device)
        self.tg, self.res, self.mg = tg, res, res.memgraph
        self.n_streams = n_streams
        self.n_transfer_streams = n_transfer_streams
        self.mode = mode
        self.policy = get_policy(policy, seed=seed)
        self.latency = latency
        self.backend = backend
        self.capacities = capacities
        self.store_factory = store_factory
        # executor backend (DESIGN.md §15): defaults to the plan's
        # BuildConfig.backend; `exec_backend` overrides per runtime. Note
        # `backend` above is the *memory* backend (slots|bytes) — a
        # distinct axis.
        self.exec_backend = (exec_backend if exec_backend is not None
                             else getattr(res, "backend", "interpreted"))
        if self.exec_backend not in ("interpreted", "compiled"):
            raise ValueError(f"unknown executor backend "
                             f"{self.exec_backend!r}")
        # seam backend (DESIGN.md §17): "auto" honours the compiler's
        # per-region stamps; "inline"/"threaded" force one backend for
        # every seam (the differential harness's forced-backend lanes)
        self.seam_backend = seam_backend
        self._compiled = None          # lazily lowered CompiledPlan cache
        # shared-pool mode (DESIGN.md §12): the runtime-owned store joins
        # an arbitrated HostPool under this lease
        self.host_lease = host_lease
        # liveness assumption A1 (DESIGN.md §14): the proof bounded this
        # plan's occupancy by the lease's guaranteed share, so the pool
        # enforces it as a checked invariant from here on
        lcert = getattr(res, "liveness_certificate", None)
        if (host_lease is not None and lcert is not None
                and lcert.ok and lcert.pool is not None
                and lcert.pool.plan_lease == host_lease.name
                and lcert.guaranteed_units is not None):
            host_lease.certified_floor = lcert.guaranteed_units

    def run(self, inputs: dict[int, Any]) -> RunResult:
        """Execute the plan once. ``inputs``: tid -> host tensor (pinned
        for a CUDA run, see :func:`~repro_torch.core.bridge.inputs_from_reference`)
        or numpy array."""
        mg = self.mg
        if self.backend == "bytes":
            if self.capacities is None:
                raise ValueError("ByteArena backend needs capacities")
            mem: Any = ByteArena(self.capacities, self.device)
        else:
            mem = SlotTable(self.device)
        owns_store = self.store_factory is None
        host = (make_store(mg, inputs, device=self.device,
                           lease=self.host_lease) if owns_store
                else self.store_factory(inputs))
        # assumption A1's disk face: a liveness-certified plan proved every
        # spill creditable, so a DiskFullError is certifier unsoundness
        lcert = getattr(self.res, "liveness_certificate", None)
        if (owns_store and lcert is not None and lcert.ok
                and isinstance(host, TieredStore)):
            host.certified_live = True
        try:
            if self.exec_backend == "compiled":
                return self._run_compiled(mem, host)
            return self._run(mem, host)
        finally:
            # every exit path (success, worker error, collection RaceError,
            # KeyboardInterrupt) releases an owned store's disk temp dir
            if owns_store:
                host.close()

    def _start(self) -> float:
        if self.device.type == "cuda":
            # the run's inputs and arena are ready before the clock starts
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _make_ctx(self, mem, host, t0: float, members) -> ExecContext:
        return ExecContext.make(self.mg, self.tg, mem, host, self.policy,
                                self.mode, self.latency, t0, members,
                                self.device)

    def _run(self, mem, host) -> RunResult:
        """Interpreted backend: the whole graph as one threaded job."""
        self.policy.prepare(self.mg)
        t0 = self._start()
        members = list(self.mg.vertices)
        ctx = self._make_ctx(mem, host, t0, members)
        fleet = ThreadedExecutor(ctx, members,
                                 n_streams=self.n_streams,
                                 n_transfer_streams=self.n_transfer_streams)
        try:
            fleet.start()
            if members:
                fleet.run_subset(members)
        except RaceError as e:
            _certified_reraise(self.res, e)
        finally:
            fleet.close()
        return self._finish(mem, host, ctx, t0,
                            n_interpreted=len(members),
                            n_threaded=len(members))

    def _region_backend(self, region) -> str:
        """The seam backend a NONDET region actually runs on: the
        compiler's stamp, unless this runtime forces one."""
        if self.seam_backend != "auto":
            return self.seam_backend
        return region.backend or THREADED

    def _run_compiled(self, mem, host) -> RunResult:
        """Compiled backend (DESIGN.md §15/§17): straight-line issue of
        certified-static regions, handing off at nondet-region seams to
        the backend the region is stamped with — the thread-free inline
        executor for small certified seams, the persistent threaded fleet
        for large windows. All executors share one :class:`ExecContext`
        (``mem``, ``host``, the run's records), so ByteArena extents,
        TieredStore tier moves, and HostPool lease accounting are exactly
        the invariants the certifiers assumed."""
        from .compile import NONDET, lower

        mg = self.mg
        pol = self.policy
        prepared = False
        if self._compiled is None:
            # lower() prepares the policy as part of linearization; that
            # same dispatch state then drives this run's seam executors
            prepared = True
            self._compiled = lower(
                self.res, policy=pol, n_streams=self.n_streams,
                n_transfer_streams=self.n_transfer_streams,
                seam_threshold=getattr(self.res, "seam_threshold", None))
        plan = self._compiled
        n_compiled = n_interpreted = n_fused = 0
        n_inline = n_threaded = 0
        # split the seams by effective backend: the fleet is sized to —
        # and threads are spun up for — ONLY the threaded-bound regions
        # (forcing inline gives a zero-thread run); the inline executor's
        # kernel covers the inline-bound ones. One shared context carries
        # the ADD_INTO lock groups of every seam vertex.
        seam_regions = [r for r in plan.regions if r.kind == NONDET]
        threaded_members = [m for r in seam_regions
                            if self._region_backend(r) == THREADED
                            for m in plan.order[r.start:r.end]]
        inline_members = [m for r in seam_regions
                          if self._region_backend(r) == INLINE
                          for m in plan.order[r.start:r.end]]
        if seam_regions and not prepared:
            # dispatch state (priorities, RNG draw) is only consumed by
            # the seam executors — an all-static plan skips it entirely
            pol.prepare(mg)
        t0 = self._start()
        ctx = self._make_ctx(mem, host, t0,
                             threaded_members + inline_members)
        fleet = None
        if threaded_members:
            fleet = ThreadedExecutor(
                ctx, threaded_members, n_streams=self.n_streams,
                n_transfer_streams=self.n_transfer_streams)
        inline = InlineExecutor(ctx, inline_members) if inline_members \
            else None
        static = StaticExecutor(ctx, plan)
        try:
            if fleet is not None:
                fleet.start()
            for ri, region in enumerate(plan.regions):
                if region.kind == NONDET:
                    # seam handoff: the region's vertex subset executes
                    # with full dispatch freedom on its backend, once the
                    # static work it may depend on has finished. The
                    # linearization is topological, so every
                    # cross-region dependency points backward.
                    static.handoff(ri)
                    mids = plan.order[region.start:region.end]
                    if self._region_backend(region) == INLINE:
                        inline.run_subset(mids)
                        n_inline += len(region)
                    else:
                        fleet.run_subset(mids)
                        n_threaded += len(region)
                    n_interpreted += len(region)
                else:
                    n_fused += static.run_region(region)
                    n_compiled += len(region)
        except RaceError as e:
            _certified_reraise(self.res, e)
        finally:
            if fleet is not None:
                fleet.close()
        return self._finish(mem, host, ctx, t0,
                            n_compiled=n_compiled,
                            n_interpreted=n_interpreted,
                            fused_dma_batches=n_fused,
                            n_inline=n_inline, n_threaded=n_threaded)

    def _finish(self, mem, host, ctx: ExecContext, t0: float,
                **counters: int) -> RunResult:
        """Fold a finished execution into a RunResult (both backends)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the run's end
        makespan = time.perf_counter() - t0
        verts = self.mg.vertices
        spans = ctx.spans
        timeline = sorted((a, b, verts[m].device, engine_of(verts[m]),
                           verts[m].name or str(m))
                          for m, (a, b) in spans.items())
        devices = sorted({v.device for v in verts.values()})
        chan = {k: 0.0 for k in TRANSFER_KINDS}
        compute: dict[int, list[tuple[float, float]]] = \
            {d: [] for d in devices}
        for (a, b, d, eng_kind, _name) in timeline:
            if eng_kind == COMPUTE:
                compute[d].append((a, b))
            else:
                chan[eng_kind] += b - a
        busy = {d: _union(iv) for d, iv in compute.items()}
        stall = {d: makespan - busy[d] for d in devices}
        launch: dict[str, float] = {}
        for m, secs in ctx.launch.items():
            kind = engine_of(verts[m])
            launch[kind] = launch.get(kind, 0.0) + secs
        disk = getattr(host, "disk", None)
        return RunResult(
            outputs=_collect_outputs(self.tg, self.res, mem, host),
            makespan=makespan, busy=busy, stall=stall, transfer_time=chan,
            offload_bytes=host.offload_bytes, reload_bytes=host.reload_bytes,
            timeline=timeline, spans=spans,
            disk_spill_bytes=disk.write_bytes if disk else 0,
            disk_load_bytes=disk.read_bytes if disk else 0,
            peak_host_bytes=host.peak_resident_bytes,
            arena_bytes=getattr(mem, "nbytes", 0),
            arena_device=(str(next(iter(mem.bufs.values())).device)
                          if getattr(mem, "bufs", None) else None),
            launch_time=launch, **counters)


# --------------------------------------------------------------------------
# directed stuck-state scheduler (liveness witness replay, DESIGN.md §14)
# --------------------------------------------------------------------------
class _StallProbe:
    """Shared state between the directed workers and their watchdog."""

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.stalled: list[Any] = []     # tags whose admission timed out
        self.done = 0                    # workers that finished unstalled
        self.abort = False


class _DiskGate:
    """A bounded disk tier reduced to its admission discipline: a unit
    counter with the same ``try_charge`` surface as a lease, so the same
    blocking-admission loop drives both replays."""

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self.used = 0
        self._lock = threading.Lock()

    def try_charge(self, n: int) -> bool:
        with self._lock:
            if self.used + n > self.capacity:
                return False
            self.used += n
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self.used -= n


def _blocking_charge(target: Any, n: int, tag: Any, probe: _StallProbe,
                     deadline: float, poll_s: float = 0.002) -> bool:
    """The blocking admission discipline the static model assumes of a
    reserving consumer: retry ``try_charge`` until it fits or the bounded
    timeout expires (the threaded analogue of the serve engine's deferred
    admissions). Records the stall on timeout and returns False."""
    while True:
        if target.try_charge(n):
            return True
        with probe.cond:
            if probe.abort or time.monotonic() >= deadline:
                probe.stalled.append(tag)
                probe.cond.notify_all()
                return False
        time.sleep(poll_s)


def _pool_of(cfg: "_lv.PoolConfig") -> tuple[HostPool, dict[str, Lease]]:
    pool = HostPool(cfg.capacity, policy=cfg.policy)
    leases = {s.name: pool.lease(s.name, min_bytes=s.min_bytes,
                                 weight=s.weight, priority=s.priority,
                                 drains_via=s.drains_via)
              for s in cfg.leases}
    return pool, leases


def _occupy_slack(cfg: "_lv.PoolConfig", leases: dict[str, Lease],
                  plan_lease: str, guaranteed: int) -> None:
    """Adversarial co-tenancy: every byte above the plan lease's
    guarantee is held by the others — the configuration a full
    revocation leaves behind, and the one the guarantee is *about*."""
    slack = cfg.capacity - guaranteed
    for s in cfg.leases:
        if s.name != plan_lease and slack > 0:
            leases[s.name].account(slack)
            slack = 0


def _run_directed(workers: list[Callable[[], None]], probe: _StallProbe,
                  timeout_s: float) -> None:
    threads = [threading.Thread(target=w, name=f"turnip-directed{i}")
               for i, w in enumerate(workers)]
    for th in threads:
        th.start()
    n = len(workers)
    with probe.cond:
        probe.cond.wait_for(
            lambda: len(probe.stalled) + probe.done >= n,
            timeout=timeout_s * 8 + 2)
        probe.abort = True
        probe.cond.notify_all()
    for th in threads:
        th.join()


def _replay_lease_floor_stall(hazard: Any, cert: Any, mg: MemGraph,
                              timeout_s: float) -> str:
    from .analyze import recover_residencies
    cfg = cert.pool
    pool, leases = _pool_of(cfg)
    plan = leases[hazard.lease]
    guaranteed = int(hazard.capacity or 0)
    _occupy_slack(cfg, leases, hazard.lease, guaranteed)
    host, _ = recover_residencies(mg)
    admit_units = {r.admit: r.units for r in host}
    release_units = {r.release: r.units
                     for r in host if r.release is not None}
    probe = _StallProbe()
    deadline = time.monotonic() + timeout_s

    def worker() -> None:
        for m in hazard.witness[:hazard.prefix]:
            if m in admit_units:
                if not _blocking_charge(plan, admit_units[m], m, probe,
                                        deadline):
                    return
            elif m in release_units:
                plan.release(release_units[m])
        with probe.cond:
            probe.done += 1
            probe.cond.notify_all()

    _run_directed([worker], probe, timeout_s)
    assert probe.stalled, (
        f"witness prefix replayed to completion without stalling — the "
        f"lease-floor hazard did not confirm: {hazard}")
    snap = pool.snapshot()
    return (f"admission {probe.stalled[0]} stalled {timeout_s}s on lease "
            f"{hazard.lease!r} with the pool static at "
            f"{snap['used_bytes']}/{snap['capacity']} B")


def _replay_disk_credit_stall(hazard: Any, cert: Any, mg: MemGraph,
                              timeout_s: float) -> str:
    from .analyze import recover_residencies
    assert cert.disk_capacity is not None
    gate = _DiskGate(cert.disk_capacity)
    _, disk = recover_residencies(mg)
    admit_units = {r.admit: r.units for r in disk}
    release_units = {r.release: r.units
                     for r in disk if r.release is not None}
    probe = _StallProbe()
    deadline = time.monotonic() + timeout_s

    def worker() -> None:
        for m in hazard.witness[:hazard.prefix + 1]:
            if m in admit_units:
                if not _blocking_charge(gate, admit_units[m], m, probe,
                                        deadline):
                    return
            elif m in release_units:
                gate.release(release_units[m])
        with probe.cond:
            probe.done += 1
            probe.cond.notify_all()

    _run_directed([worker], probe, timeout_s)
    assert probe.stalled, (
        f"witness prefix replayed to completion without stalling — the "
        f"disk-credit hazard did not confirm: {hazard}")
    return (f"spill {probe.stalled[0]} stalled {timeout_s}s with "
            f"{gate.used}/{gate.capacity} disk unit(s) held by blobs "
            f"whose drops are all downstream")


def _replay_revocation_cycle(hazard: Any, cert: Any,
                             timeout_s: float) -> str:
    cfg = cert.pool
    pool, leases = _pool_of(cfg)
    # recover the drain cycle starting from the flagged lease
    cycle = [hazard.lease]
    while True:
        spec = cfg.spec(cycle[-1])
        nxt = next((t for t in spec.drains_via
                    if cfg.spec(t) is not None), None)
        assert nxt is not None, f"no drain edge out of {cycle[-1]!r}"
        if nxt in cycle:
            cycle = cycle[cycle.index(nxt):]
            break
        cycle.append(nxt)
    # wedge: fill the pool across the cycle so every drain's charge must
    # wait for room only the next drain can free
    share = cfg.capacity // len(cycle)
    for i, name in enumerate(cycle):
        extra = cfg.capacity - share * len(cycle) if i == 0 else 0
        leases[name].account(share + extra)
    probe = _StallProbe()
    deadline = time.monotonic() + timeout_s

    def drain(name: str, nxt: str) -> Callable[[], None]:
        def worker() -> None:
            l = leases[name]
            with pool.draining(l):
                if not _blocking_charge(leases[nxt], 1, name, probe,
                                        deadline):
                    return
            with probe.cond:
                probe.done += 1
                probe.cond.notify_all()
        return worker

    workers = [drain(name, cycle[(i + 1) % len(cycle)])
               for i, name in enumerate(cycle)]
    _run_directed(workers, probe, timeout_s)
    assert len(probe.stalled) == len(cycle) and probe.done == 0, (
        f"some drain on the cycle made progress — the revocation-cycle "
        f"hazard did not confirm: stalled={probe.stalled} "
        f"done={probe.done}")
    return (f"all {len(cycle)} drains on {' -> '.join(cycle)} stalled "
            f"{timeout_s}s with the pool full "
            f"({pool.snapshot()['used_bytes']}/{cfg.capacity} B)")


def _replay_atomic_stall(hazard: Any, cert: Any, timeout_s: float) -> str:
    cfg = cert.pool
    pool, leases = _pool_of(cfg)
    guaranteed = int(hazard.capacity or 0)
    _occupy_slack(cfg, leases, hazard.lease, guaranteed)
    probe = _StallProbe()
    deadline = time.monotonic() + timeout_s

    def worker() -> None:
        if not _blocking_charge(leases[hazard.lease], hazard.expect_units,
                                "batch", probe, deadline):
            return
        with probe.cond:
            probe.done += 1
            probe.cond.notify_all()

    _run_directed([worker], probe, timeout_s)
    assert probe.stalled, (
        f"the all-or-nothing batch was admitted — the atomic-admission "
        f"hazard did not confirm: {hazard}")
    return (f"{hazard.expect_units} B all-or-nothing batch stalled "
            f"{timeout_s}s against a {guaranteed} B guarantee")


def replay_stall(hazard: Any, cert: Any, mg: MemGraph | None = None, *,
                 timeout_s: float = 0.5) -> str:
    """Replay a liveness hazard's stuck-state witness to an *actual*
    bounded-timeout stall: the directed scheduler executes the witness
    prefix against a real :class:`~repro_torch.core.pool.HostPool` (or a
    bounded disk gate) with the blocking admission discipline, and the
    flagged admission must still be refused after ``timeout_s`` of
    retries with the pool static — the dynamic confirmation for
    ``witness_kind == 'stall'`` findings, the way ``run_in_order``
    replays §13's race witnesses. Returns a one-line description of the
    observed stall; raises AssertionError if the replay makes progress
    instead."""
    kind = hazard.kind
    if kind == _lv.REVOCATION_CYCLE:
        return _replay_revocation_cycle(hazard, cert, timeout_s)
    if kind == _lv.ATOMIC_ADMISSION_STALL:
        return _replay_atomic_stall(hazard, cert, timeout_s)
    if kind == _lv.LEASE_FLOOR_STALL:
        assert mg is not None, "lease-floor replay needs the memgraph"
        return _replay_lease_floor_stall(hazard, cert, mg, timeout_s)
    if kind == _lv.DISK_CREDIT_STALL:
        assert mg is not None, "disk-credit replay needs the memgraph"
        return _replay_disk_credit_stall(hazard, cert, mg, timeout_s)
    raise AssertionError(f"no stall replay for hazard kind {kind!r}")
