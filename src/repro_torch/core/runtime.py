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
  (:mod:`~repro_torch.core.executor`): the threaded engine-stream fleet on
  CUDA streams, with completion taken from CUDA events. Ready vertices
  are ranked by a pluggable :class:`~repro_torch.core.dispatch.DispatchPolicy`;
  ``mode='fixed'`` reproduces the paper's ablation: vertices are *issued*
  strictly in the compile-time simulation order (head-of-line blocking),
  though still asynchronous once issued.

Every entry point runs on CUDA unless ``device='cpu'`` is passed. The
compiled executor backend (``exec_backend='compiled'``) and the liveness
stall replay of the reference come with ROADMAP A10 and the liveness
slice.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from .bridge import host_tensor
from .build import BuildResult
from .device import resolve_device
from .dispatch import (COMPUTE, DispatchPolicy, TRANSFER_KINDS, engine_of,
                       get_policy)
from .executor import ExecContext, ThreadedExecutor, _exec_vertex
from .memgraph import Loc, MemGraph, MemOp, MemVertex, RaceError
from .ops import get_op
from .stores import DiskStore, HostStore, TieredStore
from .taskgraph import OpKind, TaskGraph, TensorSpec

__all__ = ["HostStore", "DiskStore", "TieredStore", "SlotTable", "ByteArena",
           "run_in_order", "eval_taskgraph", "TurnipRuntime", "RunResult",
           "make_store"]


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
    are tensors of their own on ``device``; ops never write into them."""

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
                return dev[(loc.offset, loc.size)]
            except KeyError:
                raise RaceError(
                    f"read of dead/clobbered extent {loc} — racy order or "
                    f"bad memory plan") from None

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
    outputs: dict[int, torch.Tensor]
    makespan: float
    busy: dict[int, float]               # per device: compute-engine seconds
    stall: dict[int, float]              # makespan - busy (per device)
    transfer_time: dict[str, float]      # per DMA/disk channel: busy seconds
    offload_bytes: int
    reload_bytes: int
    timeline: list[tuple[float, float, int, str, str]]  # t0,t1,dev,engine,name
    spans: dict[int, tuple[float, float]]  # mid -> (start, end) wall times
    disk_spill_bytes: int = 0            # host→disk tier traffic
    disk_load_bytes: int = 0             # disk→host tier traffic
    peak_host_bytes: int = 0             # host-tier occupancy high-water mark
    arena_bytes: int = 0                 # ByteArena buffers (0 for slots)
    arena_device: str | None = None      # where the ByteArena lived
    # per engine class: host seconds spent launching vertices, the part of
    # the spans above that is not waiting for the card
    launch_time: dict[str, float] = dataclasses.field(default_factory=dict)


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
                 device: str | torch.device | None = None) -> None:
        if mode not in ("nondet", "fixed"):
            raise ValueError(mode)
        if backend not in ("slots", "bytes"):
            raise ValueError(f"unknown memory backend {backend!r}")
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
        self.exec_backend = (exec_backend if exec_backend is not None
                             else getattr(res, "backend", "interpreted"))
        if self.exec_backend == "compiled":
            raise NotImplementedError(
                "the compiled executor backend comes with the plan compiler "
                "(ROADMAP A10); run the interpreted backend")
        if self.exec_backend != "interpreted":
            raise ValueError(f"unknown executor backend "
                             f"{self.exec_backend!r}")
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
            return self._run(mem, host)
        finally:
            # every exit path (success, worker error, collection RaceError,
            # KeyboardInterrupt) releases an owned store's disk temp dir
            if owns_store:
                host.close()

    def _run(self, mem, host) -> RunResult:
        """Interpreted backend: the whole graph as one threaded job."""
        self.policy.prepare(self.mg)
        if self.device.type == "cuda":
            # the run's inputs and arena are ready before the clock starts
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        members = list(self.mg.vertices)
        ctx = ExecContext.make(self.mg, self.tg, mem, host, self.policy,
                               self.mode, self.latency, t0, members,
                               self.device)
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
        return self._finish(mem, host, ctx, t0)

    def _finish(self, mem, host, ctx: ExecContext, t0: float) -> RunResult:
        """Fold a finished execution's timeline into a RunResult."""
        timeline, spans = ctx.timeline, ctx.spans
        makespan = time.perf_counter() - t0
        devices = sorted({v.device for v in self.mg.vertices.values()})
        busy = {d: 0.0 for d in devices}
        chan = {k: 0.0 for k in TRANSFER_KINDS}
        by_dev: dict[int, list[tuple[float, float]]] = {d: [] for d in devices}
        for (a, b, d, eng_kind, _name) in timeline:
            if eng_kind == COMPUTE:
                by_dev[d].append((a, b))
            else:
                chan[eng_kind] += b - a
        for d, intervals in by_dev.items():   # union of stream intervals
            intervals.sort()
            cur_a, cur_b = None, None
            for a, b in intervals:
                if cur_b is None or a > cur_b:
                    if cur_b is not None:
                        busy[d] += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            if cur_b is not None:
                busy[d] += cur_b - cur_a
        stall = {d: makespan - busy[d] for d in devices}
        launch: dict[str, float] = {}
        for m, secs in ctx.launch.items():
            kind = engine_of(self.mg.vertices[m])
            launch[kind] = launch.get(kind, 0.0) + secs
        disk = getattr(host, "disk", None)
        return RunResult(
            outputs=_collect_outputs(self.tg, self.res, mem, host),
            makespan=makespan, busy=busy, stall=stall, transfer_time=chan,
            offload_bytes=host.offload_bytes, reload_bytes=host.reload_bytes,
            timeline=sorted(timeline), spans=spans,
            disk_spill_bytes=disk.write_bytes if disk else 0,
            disk_load_bytes=disk.read_bytes if disk else 0,
            peak_host_bytes=host.peak_resident_bytes,
            arena_bytes=getattr(mem, "nbytes", 0),
            arena_device=(str(next(iter(mem.bufs.values())).device)
                          if getattr(mem, "bufs", None) else None),
            launch_time=launch,
        )
