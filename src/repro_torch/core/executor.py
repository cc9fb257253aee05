"""The unified executor core (DESIGN.md §17), on CUDA streams.

One scheduling kernel, three backends, as in the reference. The
scheduling state machine (ready sets, dependency counts, the
:class:`~repro_torch.core.dispatch.DispatchPolicy` choice among
simultaneously ready vertices) lives in ONE place — :class:`ReadyKernel`,
copied from the reference — and the *threading model* is chosen per run
or, for a compiled plan, per region:

* :class:`ThreadedExecutor` — the persistent engine-stream worker fleet:
  one worker thread per stream of each (device, engine-class) pair,
  condition-variable wakeups on completion events — the paper's
  event-driven runtime. On CUDA each worker owns one stream of the
  device's stream set (:func:`stream_for`): ``n_streams`` compute streams
  per logical device and ``n_transfer_streams`` streams each for h2d, d2h
  and d2d. The disk engine is a host thread and owns no stream.
* :class:`InlineExecutor` — the same kernel scheduled entirely on the
  calling thread, which launches on one stream.
* :class:`StaticExecutor` — the straight-line walker for the certified
  STATIC regions of a :class:`~repro_torch.core.compile.CompiledPlan`. On
  the CPU it is the reference's walker. On CUDA it issues every
  instruction on the stream its (device, engine, stream id) names and
  never waits for a vertex: a cross-stream dependency is a
  ``wait_event`` on the predecessor's event, and the host waits only
  before a host-side effect, at a seam and at the run's end (its class
  docstring).

**When a vertex is complete.** In the reference every backend marks a
vertex done when its op *returns* (DESIGN.md §17: "an op's completion *is*
its return"). On CUDA a launch returns before the work is done, so that
rule would let a successor read an extent that is still being written,
and would let the planner's safe-overwrite edges (§13: a write to an
extent waits for every reader of its previous value) order only the
launches, not the work. The interpreters' rule: a worker launches the
vertex's work under its own stream, records a ``torch.cuda.Event`` on
that stream and calls ``event.synchronize()`` *before* it reports the
completion to the kernel (:func:`run_vertex`). Only then are the vertex's
successors published, so every successor — on whatever stream, device
engine or host thread — is launched after its predecessors' work has
finished on the card: data edges and safe-overwrite edges hold across
streams exactly as the certifier assumed. ``synchronize`` releases the
GIL, so the other streams keep launching while one waits. The events are
created with ``blocking=True`` so that a waiting worker sleeps instead of
spinning on a CPU core. The static walker keeps the same edges on the
card with event waits instead of host waits. On the CPU there are no
streams: an op's completion is its return, as in the reference.

**What a vertex's span is.** A span is host time: from the vertex's pick
until the host knew it complete (:class:`ExecContext` ``spans``; for the
static walker, until its launches returned), and ``launch`` is the part
of it spent launching. The run's timeline, ``busy`` and ``stall`` are
built from the spans (``RunResult``). On CUDA a span therefore holds the
host's issue time and, for the interpreters, the wait for the card: it
bounds the card's time for the vertex from above, and a profiler's
kernel intervals are the card's own.

**Pinned host memory.** Host tensors are pinned and come from torch's
caching host allocator, which does not hand a block out again until the
copies recorded against it have finished; a host-side effect (a disk
spill reading a pinned buffer, a drop releasing one) is only issued after
the copies that touch it have completed (:class:`StaticExecutor`).

Nondeterminism semantics are unchanged end-to-end: any backend executes
some dependency-respecting order the policy could have chosen, and the
plan certifier (§13) proved every such order byte-exact.

The kernel itself is not locked: the inline executor drives it from one
thread, and the threaded executor wraps every kernel call in its
scheduler lock (a :func:`lockcheck.make_lock` sanitized lock, so the
lock-order sanitizer audits it with the store/pool locks).

:func:`select_best` is the kernel's dispatch primitive — "among the
simultaneously-ready candidates, take the policy minimum".
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, Sequence, TypeVar

import torch

from . import lockcheck
from .dispatch import COMPUTE, DISK, DispatchPolicy, engine_of
from .memgraph import MemGraph, MemOp, MemVertex
from .ops import get_op
from .stores import HostStore
from .taskgraph import TaskGraph

__all__ = ["ExecContext", "ReadyKernel", "InlineExecutor",
           "ThreadedExecutor", "StaticExecutor", "select_best", "run_vertex",
           "stream_for", "INLINE", "THREADED"]

# nondet-region backend hints (compile.Region.backend / RunResult counters)
INLINE = "inline"
THREADED = "threaded"

_T = TypeVar("_T")


def select_best(candidates: Sequence[_T],
                rank: Callable[[_T], Any]) -> int:
    """The kernel's dispatch choice, as a primitive: the index of the
    minimum-``rank`` candidate among the simultaneously-ready set.
    ``rank`` is evaluated at pop time, so callers with *dynamic*
    priorities (the serving engine's reload policies) share the exact
    selection rule the static-priority heaps implement."""
    best = 0
    best_rank = rank(candidates[0])
    for i in range(1, len(candidates)):
        r = rank(candidates[i])
        if r < best_rank:
            best, best_rank = i, r
    return best


# --------------------------------------------------------------------------
# the device's stream set
# --------------------------------------------------------------------------
_STREAMS: dict[tuple, "torch.cuda.Stream"] = {}
_STREAMS_LOCK = threading.Lock()


def stream_for(device: torch.device, engine: str, logical: int,
               index: int) -> "torch.cuda.Stream | None":
    """The stream of one (logical device, engine class, stream id) of a run
    on ``device``: ``None`` on the CPU and for the disk engine (a host
    thread). Streams are made once per process and shared by every run
    and backend, so a run's cuBLAS workspaces (one per handle and stream)
    and its stream count are fixed by ``n_streams`` and
    ``n_transfer_streams``, not by how many runs came before. Sharing a
    stream between two executors adds order, never removes it."""
    if device.type != "cuda" or engine == DISK:
        return None
    key = (device.index, engine, logical, index)
    with _STREAMS_LOCK:
        st = _STREAMS.get(key)
        if st is None:
            st = _STREAMS[key] = torch.cuda.Stream(device=device)
        return st


# --------------------------------------------------------------------------
# vertex execution (shared by every backend and the reference interpreter)
# --------------------------------------------------------------------------
def _exec_vertex(v: MemVertex, mg: MemGraph, tg: TaskGraph, mem: Any,
                 host: HostStore) -> None:
    """Launch one vertex's work on the current stream. Values are device
    tensors read from, and written into, the memory backend ``mem``; an op
    writes straight into its planned extent where the backend has one
    (:meth:`ByteArena.dest`)."""
    if v.op in (MemOp.COMPUTE, MemOp.TRANSFER):
        vals = [mem.read(mg.vertices[m].loc) for m in v.operands]
        fn = get_op(v.op_name or ("copy" if v.op == MemOp.TRANSFER else ""))
        dest = mem.dest(v.loc, tg.vertices[v.src_tid].out)
        mem.write(v.loc, fn(*vals, out=dest, **v.params))
        return
    if v.op == MemOp.INPUT:
        mem.write(v.loc, host.get_input(v.src_tid))       # h2d copy
    elif v.op == MemOp.OFFLOAD:
        # d2h copy into a fresh pinned host tensor
        host.put_offload(v.mid, mem.read(mg.vertices[v.operands[0]].loc))
    elif v.op == MemOp.RELOAD:
        mem.write(v.loc, host.get_for_reload(v))
    elif v.op == MemOp.SPILL:
        # second hop of a tiered eviction (host→disk) — or a free release
        # of dead bytes. operands[0] is the host-store key.
        host.spill(v.operands[0], drop=bool(v.params.get("drop")))
    elif v.op == MemOp.LOAD:
        host.load(v.operands[0])   # first hop of a two-hop reload
    elif v.op == MemOp.ALLOC0:
        mem.zero(v.loc, tg.vertices[v.src_tid].out)
    elif v.op == MemOp.ADD_INTO:
        mem.add_into(v.loc, mem.read(mg.vertices[v.operands[0]].loc))
    elif v.op == MemOp.JOIN:
        pass  # completion marker: the accumulator already holds the value
    else:  # pragma: no cover
        raise AssertionError(f"unknown op {v.op}")


@dataclasses.dataclass
class ExecContext:
    """Everything a backend needs to execute vertices of one run: the
    plan's graphs, the shared memory/store tiers, the dispatch policy,
    and the run-wide span records. One context is shared by every
    backend of a run, so ByteArena extents, TieredStore tier moves, and
    HostPool lease accounting are exactly the invariants the certifiers
    assumed — regardless of which backend touches them."""

    mg: MemGraph
    tg: TaskGraph
    mem: Any
    host: HostStore
    policy: DispatchPolicy
    mode: str                                    # "nondet" | "fixed"
    latency: Callable[[MemVertex], float] | None
    t0: float                                    # host clock at the start
    device: torch.device = torch.device("cpu")   # where vertices run
    # mid -> host (start, end) seconds since t0: from the vertex's pick
    # until its completion was known to the host (for the static walker:
    # until its launch returned)
    spans: dict[int, tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    # mid -> host seconds from a vertex's start until its launch returned
    # (the rest of its span is the wait for the card)
    launch: dict[int, float] = dataclasses.field(default_factory=dict)
    # §B write-protected sum-into: one lock per ADD_INTO lock group
    locks: dict[tuple[int, int], threading.Lock] = dataclasses.field(
        default_factory=dict)

    @staticmethod
    def make(mg: MemGraph, tg: TaskGraph, mem: Any, host: HostStore,
             policy: DispatchPolicy, mode: str,
             latency: Callable[[MemVertex], float] | None,
             t0: float, members: Sequence[int],
             device: torch.device) -> "ExecContext":
        locks: dict[tuple[int, int], threading.Lock] = {}
        for m in members:
            g = mg.vertices[m].lock_group
            if g is not None:
                locks.setdefault(g, threading.Lock())
        return ExecContext(mg=mg, tg=tg, mem=mem, host=host, policy=policy,
                           mode=mode, latency=latency, t0=t0, device=device,
                           locks=locks)

    def stream(self, engine: str, logical: int = 0,
               index: int = 0) -> "torch.cuda.Stream | None":
        """This run's stream for (engine, logical device, stream id)."""
        return stream_for(self.device, engine, logical, index)


def _exec_complete(ctx: ExecContext, v: MemVertex,
                   stream: "torch.cuda.Stream | None") -> float:
    """Launch ``v`` on ``stream`` and return once its work has finished
    on the card: the event-synchronised completion rule (module
    docstring). Without a stream the op's return is its completion.
    Returns the host clock at which the launch had returned."""
    if stream is None:
        _exec_vertex(v, ctx.mg, ctx.tg, ctx.mem, ctx.host)
        return time.perf_counter()
    with torch.cuda.stream(stream):
        _exec_vertex(v, ctx.mg, ctx.tg, ctx.mem, ctx.host)
        done = torch.cuda.Event(blocking=True)
        done.record(stream)
    launched = time.perf_counter()
    done.synchronize()
    return launched


def run_vertex(ctx: ExecContext, m: int,
               stream: "torch.cuda.Stream | None" = None) -> None:
    """Execute one vertex with the run's latency model and ADD_INTO lock
    discipline, recording its span. Shared by the inline and threaded
    backends. Returns once the vertex's work has finished (on ``stream``,
    when given)."""
    v = ctx.mg.vertices[m]
    t_start = time.perf_counter() - ctx.t0
    if ctx.latency is not None:
        d = ctx.latency(v)
        if d > 0:
            time.sleep(d)
    lk = ctx.locks.get(v.lock_group) if v.lock_group is not None else None
    if lk is not None and v.op == MemOp.ADD_INTO:
        # §B: write-protected sum-into. The lock is held until the add has
        # finished on the card, so two streams never add into one
        # accumulator at once.
        with lk:
            launched = _exec_complete(ctx, v, stream)
    else:
        launched = _exec_complete(ctx, v, stream)
    ctx.spans[m] = (t_start, time.perf_counter() - ctx.t0)
    ctx.launch[m] = launched - ctx.t0 - t_start


# --------------------------------------------------------------------------
# the shared scheduling kernel
# --------------------------------------------------------------------------
class ReadyKernel:
    """The ready-set/dispatch state machine every backend schedules with.

    State: per-vertex remaining-dependency counts, one priority heap per
    (device, engine-class) key ordered by ``(policy.priority, seq, mid)``,
    and — in ``mode='fixed'`` — the strict compile-time issue order with
    head-of-line blocking. The kernel carries NO locking: the inline
    executor drives it from a single thread; the threaded executor holds
    its scheduler lock around every call.

    A job is any subset of ``members``; predecessors outside the job are
    treated as already complete (sound for the compiled backend: the
    linearization is topological, so cross-region deps point backward).
    """

    def __init__(self, mg: MemGraph, members: Sequence[int],
                 policy: DispatchPolicy, mode: str) -> None:
        self.mg = mg
        self.verts = mg.vertices
        self.policy = policy
        self.mode = mode
        keys = {(self.verts[m].device, engine_of(self.verts[m]))
                for m in members}
        self.engine_keys: list[tuple[int, str]] = sorted(keys)
        self.heaps: dict[tuple[int, str], list[tuple[float, int, int]]] = \
            {k: [] for k in self.engine_keys}
        # fixed mode: seq -> mid of dep-complete vertices + the issue order
        self.ready_fixed: dict[int, int] = {}
        self.seq_order: list[int] = []
        self.next_i = 0
        # per-job state
        self.remaining: dict[int, int] = {}
        self.n_done = 0
        self.total = 0

    # ---- job lifecycle ------------------------------------------------
    def load(self, mids: Sequence[int]) -> list[int]:
        """Begin a job over ``mids``: reset counts and return the
        initially dep-complete vertices (NOT yet published — the caller
        publishes, so the threaded backend can pair each publish with its
        engine wakeup)."""
        subset = set(mids)
        self.remaining = {m: sum(1 for p in self.mg.preds[m] if p in subset)
                          for m in mids}
        self.n_done = 0
        self.total = len(mids)
        if self.mode == "fixed":
            self.seq_order = sorted(self.verts[m].seq for m in mids)
            self.next_i = 0
        return [m for m, r in self.remaining.items() if r == 0]

    @property
    def done(self) -> bool:
        return self.n_done >= self.total

    # ---- ready-set operations ----------------------------------------
    def publish(self, m: int) -> tuple[int, str] | None:
        """Make a dep-complete vertex poppable. Returns the engine key
        whose ready set grew (``None`` in fixed mode — the head-of-line
        queue is global)."""
        v = self.verts[m]
        if self.mode == "fixed":
            self.ready_fixed[v.seq] = m
            return None
        key = (v.device, engine_of(v))
        heapq.heappush(self.heaps[key],
                       (self.policy.priority(m), v.seq, m))
        return key

    def pop(self, key: tuple[int, str]) -> int | None:
        """Pop the policy-best ready vertex of one engine key (a threaded
        worker's view: each stream races only within its engine class)."""
        heap = self.heaps[key]
        if not heap:
            return None
        return heapq.heappop(heap)[2]

    def pop_fixed(self, key: tuple[int, str] | None = None) -> int | None:
        """Fixed-mode head-of-line issue: the next vertex of the strict
        seq order, if dep-complete (and on ``key``'s engine when given).
        ``None`` = the head is not ready / not ours — wait."""
        if self.next_i >= len(self.seq_order):
            return None
        m = self.ready_fixed.get(self.seq_order[self.next_i])
        if m is None:
            return None
        if key is not None:
            v = self.verts[m]
            if (v.device, engine_of(v)) != key:
                return None
        del self.ready_fixed[self.seq_order[self.next_i]]
        self.next_i += 1
        return m

    def pop_best(self) -> int | None:
        """Inline dispatch: the policy-best vertex across EVERY engine's
        ready set — the choice one caller thread makes when it is all the
        engines at once. Same ``(priority, seq)`` ordering as the
        per-engine heaps, so the policy's preference structure is
        identical between backends."""
        if self.mode == "fixed":
            return self.pop_fixed()
        keys = [k for k in self.engine_keys if self.heaps[k]]
        if not keys:
            return None
        best = keys[select_best(keys, lambda k: self.heaps[k][0])]
        return heapq.heappop(self.heaps[best])[2]

    def ready_view(self) -> dict[tuple[int, str], list[int]]:
        """Snapshot of the ready sets (tests: backend equivalence)."""
        if self.mode == "fixed":
            out: dict[tuple[int, str], list[int]] = {}
            for m in self.ready_fixed.values():
                v = self.verts[m]
                out.setdefault((v.device, engine_of(v)), []).append(m)
            return {k: sorted(v) for k, v in out.items()}
        return {k: sorted(t[2] for t in h)
                for k, h in self.heaps.items() if h}

    def complete(self, m: int) -> list[int]:
        """Record a completion event and return the vertices it made
        dep-complete. Backends call this only after the vertex's work has
        finished (its CUDA event has fired), so there is nothing to wait
        on here."""
        self.n_done += 1
        out: list[int] = []
        for s in self.mg.succs[m]:
            if s in self.remaining:
                self.remaining[s] -= 1
                if self.remaining[s] == 0:
                    out.append(s)
        return out

    def clear_ready(self) -> None:
        """Error path: nothing more launches."""
        for heap in self.heaps.values():
            heap.clear()
        self.ready_fixed.clear()


# --------------------------------------------------------------------------
# the thread-free inline executor
# --------------------------------------------------------------------------
class InlineExecutor:
    """Run a nondet seam entirely on the calling thread.

    Same kernel, same policy choice among simultaneously-ready vertices,
    same RaceError/tier semantics — zero thread wakeups. The loop is the
    event-driven scheduler collapsed to one thread: pop the policy-best
    ready vertex, execute it on the executor's one stream and wait for its
    event, drain its completion through the kernel, publish the
    newly-ready. Legal because any dependency-respecting order is
    certified byte-exact (§13)."""

    def __init__(self, ctx: ExecContext, members: Sequence[int]) -> None:
        self.ctx = ctx
        self.kernel = ReadyKernel(ctx.mg, members, ctx.policy, ctx.mode)
        self.stream = ctx.stream(INLINE)

    def run_subset(self, mids: Sequence[int]) -> None:
        """Execute one job to completion on the calling thread. Errors
        propagate directly — there is no worker to surface them from."""
        k = self.kernel
        for m in k.load(mids):
            k.publish(m)
        while not k.done:
            m = k.pop_best()
            assert m is not None, \
                "ready set drained before the job completed (cyclic deps?)"
            run_vertex(self.ctx, m, self.stream)
            for s in k.complete(m):
                k.publish(s)


# --------------------------------------------------------------------------
# the threaded engine-stream fleet
# --------------------------------------------------------------------------
class _Engine:
    """One engine class of one device: its kernel ready-heap key + a
    wakeup condition. All engines share the scheduler's single sanitized
    lock; each carries its own condition variable so a completion event
    wakes only streams that gained work."""

    __slots__ = ("key", "cond")

    def __init__(self, key: tuple[int, str],
                 lock: lockcheck.SanitizedLock) -> None:
        self.key = key
        self.cond = threading.Condition(lock)


class ThreadedExecutor:
    """A persistent pool of engine-stream worker threads executing
    dependency-complete vertices — the paper's event-driven runtime.

    Thread start-up is paid ONCE per run: the runtime submits the whole
    graph as a single job.

    ``members`` sizes the engines: only (device, engine-class) pairs
    actually present get streams. On CUDA every worker of a compute or
    DMA engine owns one ``torch.cuda.Stream``; disk workers own none.
    The scheduler lock is a :func:`lockcheck.make_lock` sanitized lock — the lock-order sanitizer
    audits its acquisition pairs along with the store/pool locks (it must
    stay a leaf: no other sanitized lock is ever taken under it)."""

    def __init__(self, ctx: ExecContext, members: Sequence[int], *,
                 n_streams: int = 5, n_transfer_streams: int = 1) -> None:
        self.ctx = ctx
        per_key: dict[tuple[int, str], int] = {}
        verts = ctx.mg.vertices
        for m in members:
            key = (verts[m].device, engine_of(verts[m]))
            per_key[key] = per_key.get(key, 0) + 1

        # ---- scheduler state (all guarded by `lock`) ------------------
        self.lock = lockcheck.make_lock("ExecutorScheduler")
        self.kernel = ReadyKernel(ctx.mg, members, ctx.policy, ctx.mode)
        self.engines = {key: _Engine(key, self.lock)
                        for key in sorted(per_key)}
        self.main_cond = threading.Condition(self.lock)
        self.fixed_cond = threading.Condition(self.lock)
        self.errors: list[BaseException] = []
        self.shutdown = False

        self.threads: list[threading.Thread] = []
        for (d, kind), eng in self.engines.items():
            width = n_streams if kind == COMPUTE else n_transfer_streams
            width = max(1, min(width, per_key[(d, kind)]))
            for i in range(width):
                stream = ctx.stream(kind, d, i)
                if ctx.mode == "fixed":
                    th = threading.Thread(target=self._worker_fixed,
                                          args=((d, kind), stream),
                                          name=f"turnip-{kind}{d}.{i}")
                else:
                    th = threading.Thread(target=self._worker_nondet,
                                          args=(eng, stream),
                                          name=f"turnip-{kind}{d}.{i}")
                self.threads.append(th)
        self.started: list[threading.Thread] = []

    def start(self) -> None:
        """Start every stream. On a mid-fleet OS refusal the caller's
        ``close()`` (in its finally) drains the partial fleet."""
        for th in self.threads:
            th.start()
            self.started.append(th)

    def close(self) -> None:
        """Deterministic drain — success, worker error, thread-start
        failure, or KeyboardInterrupt alike: every started stream
        observes ``shutdown`` and exits; no timeout, no leaked threads."""
        with self.lock:
            self.shutdown = True
            for eng in self.engines.values():
                eng.cond.notify_all()
            self.fixed_cond.notify_all()
            self.main_cond.notify_all()
        for th in self.started:
            th.join()

    def run_subset(self, mids: Sequence[int]) -> None:
        """Execute one job: every vertex of ``mids``, any legal order.
        Blocks until the job completes; raises the first worker error."""
        k = self.kernel
        with self.lock:
            if self.errors:
                raise self.errors[0]
            for m in k.load(mids):
                self._publish(m)
            while not k.done and not self.errors:
                self.main_cond.wait()
            if self.errors:
                raise self.errors[0]

    # ---- internals ----------------------------------------------------
    def _publish(self, m: int) -> None:
        """Lock held. Publish a dep-complete vertex + wake its engine."""
        key = self.kernel.publish(m)
        if key is None:                       # fixed mode: global queue
            self.fixed_cond.notify_all()
        else:
            self.engines[key].cond.notify()

    def _worker_nondet(self, eng: _Engine, stream) -> None:
        if stream is not None:
            torch.cuda.set_device(stream.device)
        k = self.kernel
        while True:
            with self.lock:
                m = k.pop(eng.key)
                while m is None and not self.shutdown:
                    eng.cond.wait()
                    m = k.pop(eng.key)
                if m is None:
                    return                    # shutdown
            self._run_vertex(m, stream)

    def _worker_fixed(self, key: tuple[int, str], stream) -> None:
        if stream is not None:
            torch.cuda.set_device(stream.device)
        k = self.kernel
        while True:
            with self.lock:
                m = k.pop_fixed(key)
                while m is None and not self.shutdown:
                    self.fixed_cond.wait()
                    m = k.pop_fixed(key)
                if m is None:
                    return                    # shutdown
                # the new head may belong to any engine: wake everyone
                self.fixed_cond.notify_all()
            self._run_vertex(m, stream)

    def _run_vertex(self, m: int, stream) -> None:
        try:
            run_vertex(self.ctx, m, stream)
        except BaseException as e:     # surface in run_subset's caller
            with self.lock:
                self.errors.append(e)
                self.kernel.clear_ready()     # nothing more launches
                self.main_cond.notify_all()
            return
        with self.lock:                       # the vertex's work is done
            for s in self.kernel.complete(m):
                self._publish(s)
            if self.kernel.done:
                self.main_cond.notify_all()


# --------------------------------------------------------------------------
# the straight-line walker (certified STATIC regions)
# --------------------------------------------------------------------------
_COPY_KINDS = ("h2d", "d2h", "d2d")


class StaticExecutor:
    """Execute a :class:`~repro_torch.core.compile.CompiledPlan`'s STATIC
    regions straight-line on the calling thread: no heap, no locks, no
    condition variables — the precomputed tick counts proved position
    order is dependency order, so the assert is the entire per-vertex
    dispatch. A fused DMA batch issues as one submission: its members back
    to back on its head's stream.

    On the CPU this is the reference's walker: each op's return is its
    completion. On CUDA the walker never waits for a vertex:

    * every instruction is issued on the stream its (engine, device,
      stream id) names — a fused batch's members on their head's;
    * an end event is recorded after an instruction's work only where
      something waits for it (``needs_end``, from the lowering): a
      successor on another stream, a seam, a later add of its lock group
      (every grouped ADD_INTO), a host-side effect (every copy);
    * before issuing, that stream waits on the end event of every memgraph
      predecessor that was issued on another stream of a static region
      (``waits``, taken from the lowering; a predecessor in a nondet
      region has already completed, and one on the same stream is ordered
      by the stream). Safe-overwrite edges are memgraph edges, so a write
      to an extent still waits for the reads of its previous value;
    * an ADD_INTO also waits on the previous static ADD_INTO of its lock
      group in linear order: two streams never add into one accumulator
      at once, and the adds happen in one order, so two compiled runs of
      an all-static plan give the same bytes;
    * a host-side vertex (the disk engine: a spill, a load, a drop) runs
      on the host once the host has synchronised the events of its static
      predecessors and the last copy issued on every copy stream: no
      pinned buffer is read, written or released while a copy is in
      flight on it;
    * :meth:`handoff`, before a nondet region: the host synchronises the
      static instructions that have successors in the region and the last
      static ADD_INTO of every lock group the region adds into (both known
      when the plan is lowered), so the region's executor may treat every
      earlier vertex as complete.

    The caller synchronises the device at the run's end. The fused H2D/D2H
    pair of a liveness-certified plan therefore runs both directions on
    the head's one copy stream: the lowering is the reference's."""

    def __init__(self, ctx: ExecContext, plan: Any) -> None:
        self.ctx = ctx
        self.plan = plan
        self.heads: dict[int, tuple[int, int]] = plan.batch_heads
        self.cuda = ctx.device.type == "cuda"
        mg, instrs = ctx.mg, plan.instrs
        head_of = {i: a for a, b in plan.batches for i in range(a, b)}
        static = [plan.regions[ins.region].kind == "static"
                  for ins in instrs]
        # the stream each position issues on: (engine, device, stream id),
        # or None for the host (the disk engine)
        lanes: list[tuple[str, int, int] | None] = []
        for ins in instrs:
            h = instrs[head_of.get(ins.pos, ins.pos)]
            lanes.append(None if h.engine == DISK
                         else (h.engine, h.device, h.stream))
        pos = {ins.mid: ins.pos for ins in instrs}

        def on_card(p: int) -> bool:           # issued async by this walker
            return static[pos[p]] and lanes[pos[p]] is not None

        self.lanes = lanes
        self.waits: list[tuple[int, ...]] = [()] * len(instrs)
        prev_add: dict[tuple[int, int], int] = {}
        for ins in instrs:
            i = ins.pos
            if not static[i]:
                continue
            w = {p for p in mg.preds[ins.mid]
                 if on_card(p) and lanes[pos[p]] != lanes[i]}
            v = mg.vertices[ins.mid]
            if v.op == MemOp.ADD_INTO and v.lock_group is not None:
                p = prev_add.get(v.lock_group)
                if p is not None and lanes[pos[p]] != lanes[i] \
                        and lanes[pos[p]] is not None:
                    w.add(p)
                prev_add[v.lock_group] = ins.mid
            self.waits[i] = tuple(sorted(w))
        # seam handoff sets, per nondet region index
        self.seam_preds: dict[int, tuple[int, ...]] = {}
        self.seam_groups: dict[int, tuple[tuple[int, int], ...]] = {}
        for ri, r in enumerate(plan.regions):
            if r.kind == "static":
                continue
            preds: set[int] = set()
            groups: set[tuple[int, int]] = set()
            for m in plan.order[r.start:r.end]:
                preds.update(p for p in mg.preds[m] if on_card(p))
                v = mg.vertices[m]
                if v.op == MemOp.ADD_INTO and v.lock_group is not None:
                    groups.add(v.lock_group)
            self.seam_preds[ri] = tuple(sorted(preds))
            self.seam_groups[ri] = tuple(sorted(groups))
        # the instructions whose end event something waits for
        self.needs_end: set[int] = set()
        for w in self.waits:
            self.needs_end.update(w)
        for preds in self.seam_preds.values():
            self.needs_end.update(preds)
        for ins in instrs:                      # copies and grouped adds
            v = mg.vertices[ins.mid]
            if on_card(ins.mid) and (
                    lanes[ins.pos][0] in _COPY_KINDS or
                    (v.op == MemOp.ADD_INTO and v.lock_group is not None)):
                self.needs_end.add(ins.mid)
        # run state: end events, the last copy per copy stream, the last
        # static ADD_INTO per lock group
        self.ends: dict[int, Any] = {}
        self.last_copy: dict[tuple[str, int, int], Any] = {}
        self.group_last: dict[tuple[int, int], int] = {}

    def run_region(self, region: Any) -> int:
        """Issue one STATIC region; returns the fused submissions issued."""
        n_fused = 0
        i = region.start
        while i < region.end:
            span = self.heads.get(i)
            if span is not None:
                for j in range(span[0], span[1]):
                    self._exec(j)
                n_fused += 1
                i = span[1]
            else:
                self._exec(i)
                i += 1
        return n_fused

    def handoff(self, region_index: int) -> None:
        """Before nondet region ``region_index`` runs: wait on the host for
        the static work it may depend on (class docstring)."""
        if not self.cuda:
            return
        for p in self.seam_preds[region_index]:
            self.ends[p].synchronize()
        for g in self.seam_groups[region_index]:
            m = self.group_last.get(g)
            if m is not None:
                self.ends[m].synchronize()

    def _exec(self, i: int) -> None:
        ins = self.plan.instrs[i]
        assert ins.ready_tick <= i, "compiled plan not topological"
        ctx = self.ctx
        v = ctx.mg.vertices[ins.mid]
        t_start = time.perf_counter() - ctx.t0
        if ctx.latency is not None:
            d = ctx.latency(v)
            if d > 0:
                time.sleep(d)
        lane = self.lanes[i]
        if not self.cuda or lane is None:
            if self.cuda:                      # a host-side effect
                for p in self.waits[i]:
                    self.ends[p].synchronize()
                for ev in self.last_copy.values():
                    ev.synchronize()
            _exec_vertex(v, ctx.mg, ctx.tg, ctx.mem, ctx.host)
        else:
            stream = ctx.stream(*lane)
            for p in self.waits[i]:
                stream.wait_event(self.ends[p])
            with torch.cuda.stream(stream):
                _exec_vertex(v, ctx.mg, ctx.tg, ctx.mem, ctx.host)
            if ins.mid in self.needs_end:
                end = torch.cuda.Event(blocking=True)
                end.record(stream)
                self.ends[ins.mid] = end
                if lane[0] in _COPY_KINDS:
                    self.last_copy[lane] = end
            if v.op == MemOp.ADD_INTO and v.lock_group is not None:
                self.group_last[v.lock_group] = ins.mid
        t_end = time.perf_counter() - ctx.t0
        ctx.spans[ins.mid] = (t_start, t_end)
        ctx.launch[ins.mid] = t_end - t_start
