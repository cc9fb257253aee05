"""Plan compilation: lower a certified MEMGRAPH into a straight-line
executor program (DESIGN.md §15; ROADMAP item 4).

The threaded :class:`~repro_torch.core.runtime.TurnipRuntime` *interprets* the
memgraph vertex-by-vertex: every launch takes a lock round-trip, a heap
pop, and a condition-variable wakeup. TURNIP's own argument says that
freedom only pays where transfer completion times are unknown at compile
time; everywhere else the plan certifier (DESIGN.md §13) has already
proved **every** legal execution order race-free and tier-coherent, so
those spans can be frozen into a zero-dispatch program.

:func:`lower` turns a built :class:`~repro_torch.core.build.BuildResult` plus a
chosen :class:`~repro_torch.core.dispatch.DispatchPolicy` into a
:class:`CompiledPlan`:

* **linearization** — one topological order of the memgraph, tie-broken
  by the policy's static priorities, so the compiled program makes the
  same choices the event loop would make when nothing is in flight;
* **pre-resolved engines/streams** — every instruction carries its
  engine class and a round-robin stream id fixed at compile time (the
  runtime no longer consults ``engine_of`` or a ready heap per vertex);
* **dependency tick counts** — ``Instr.ready_tick`` is one past the
  linear position of the instruction's last predecessor. Because the
  linearization is topological, ``ready_tick <= pos`` holds for every
  instruction — proved once at compile time (:meth:`CompiledPlan.verify`)
  — so the straight-line executor needs no per-vertex dependency
  bookkeeping at all: position order *is* dependency order;
* **region segmentation** — a compile-time replay of the linearization
  finds the spans where the runtime's choice could genuinely respond to
  real-time transfer completions: a *nondeterministic window* is open at
  a position when ≥2 timing-sensitive vertices (byte-moving transfers,
  or vertices directly fed by one) are simultaneously ready on the same
  engine class. Maximal marked spans become ``nondet`` regions that fall
  back to the interpreter at their seam vertex; everything else is a
  ``static`` region executed straight-line. Segmentation is *never* a
  correctness decision — the certificate proved all orders safe — it
  preserves the paper's performance nondeterminacy where it can matter;
* **seam-backend stamping** (DESIGN.md §17) — every nondet region is
  stamped with the executor backend its seam should run on: ``inline``
  (the thread-free ready-heap executor on the calling thread) when the
  region is small (``seam_threshold``, ``BuildConfig`` knob), narrow
  (ready width ≤ :data:`MAX_INLINE_WIDTH`), and certified stall-free on
  the caller (``liveness.inline_seam_certified`` — an ``ok`` §14
  certificate, or no pool/disk admission ops at all); ``threaded`` (the
  persistent engine-stream fleet) otherwise. The runtime can force
  either backend (``seam_backend``) — stamping is a performance hint
  with a certified safety floor, never a correctness decision;
* **fused DMA batches** — maximal runs of adjacent same-(device, engine)
  DMA instructions inside a static region are fused into one batched
  submission: one enqueue, one completion wait. Legality is structural:
  the linearization is topological and a batch is a contiguous span, so
  every member's out-of-batch predecessor necessarily sits *before* the
  batch head — all external dependencies are complete when the batch
  issues, and in-batch order is preserved by the stream's FIFO. Runs on
  the ``disk`` engine additionally require an ``ok`` liveness
  certificate (DESIGN.md §14): a fused disk submission holds several
  credit admissions behind a single completion wait, which is only
  known stall-free because the liveness proof bounded every admission.
  Under the same certificate the H2D/D2H *engine pair* of one device
  fuses too: both directions drain through one DMA controller, and the
  liveness proof bounds every admission the paired batch can hold.

Plans whose soundness certificate is missing or not ``ok`` lower to a
single whole-plan ``nondet`` region: the interpreter keeps full freedom
and the compiled backend adds nothing but the counters.

The module is the reference's, copied: the port is held to *plan
equality* — the same BuildResult lowers to the same instructions, regions
and batches in both packages. What a CompiledPlan means on CUDA streams
(each instruction on the stream its (device, engine, stream) names,
cross-stream edges as event waits, host waits only at seams and
host-side effects) is :class:`~repro_torch.core.executor.StaticExecutor`'s
business.

CLI::

    PYTHONPATH=src python -m repro_torch.core.compile --seeds 24 --device cpu

lowers the seeded example-plan corpus under every dispatch policy,
verifies each plan's tick counts / regions / batches, and replays the
linearization through the sequential interpreter against the dataflow
oracle — every certified plan must lower and replay byte-exactly — then
runs the full compiled executor on ``--device`` (default CUDA).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import TYPE_CHECKING, Sequence

from .analyze import certify
from .dispatch import (COMPUTE, D2H, DISK, H2D, TRANSFER_KINDS,
                       DispatchPolicy, engine_key, engine_of, get_policy)
from .executor import INLINE, THREADED
from .liveness import LivenessCertificate, inline_seam_certified
from .memgraph import MemGraph, MemOp

if TYPE_CHECKING:                      # no import cycle at runtime
    from .build import BuildResult

__all__ = ["CompiledPlan", "Instr", "Region", "PlanCompileError", "lower"]

STATIC = "static"
NONDET = "nondet"

# adjacent nondet regions separated by fewer than this many static
# positions are merged: each seam hands a thread fleet up and back down,
# so hairline static slivers between two windows cost more than they save
DEFAULT_MERGE_GAP = 3

# fused submissions are bounded so one batch's completion wait cannot
# defer an unboundedly long tail of downstream work
MAX_FUSE = 16

# seam-backend stamping (DESIGN.md §17): a nondet region at most this
# long runs on the thread-free inline executor — overridable per plan via
# BuildConfig.seam_threshold. Above it (or when the region's ready sets
# grow wider than MAX_INLINE_WIDTH — enough concurrent freedom that real
# streams could genuinely overlap), the threaded fleet keeps the paper's
# parallel event loop.
DEFAULT_SEAM_THRESHOLD = 64
MAX_INLINE_WIDTH = 8


class PlanCompileError(RuntimeError):
    """A CompiledPlan failed verification (lowering bug, or a hand-edited
    plan violating the tick/region/batch invariants)."""


@dataclasses.dataclass(frozen=True)
class Instr:
    """One lowered instruction: a memgraph vertex with its dispatch
    decisions pre-resolved."""

    mid: int
    pos: int                 # position in the linear order
    device: int
    engine: str              # engine class (dispatch.ENGINE_KINDS)
    stream: int              # pre-assigned stream id within (device, engine)
    ready_tick: int          # 1 + max linear position of predecessors (0 = source)
    region: int              # index into CompiledPlan.regions
    batch: int               # head position of the fused batch, or own pos


@dataclasses.dataclass(frozen=True)
class Region:
    """A contiguous span ``[start, end)`` of the linear order."""

    kind: str                # STATIC | NONDET
    start: int
    end: int
    # NONDET regions carry the seam backend the compiler chose for them
    # (DESIGN.md §17): "inline" for small certified seams, "threaded"
    # for large windows. STATIC regions leave it "".
    backend: str = ""

    def __len__(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class CompiledPlan:
    """The lowered program: linear order, instructions, regions, batches.

    ``batches`` are index spans ``(a, b)`` into ``order`` with
    ``b - a >= 2``: the instructions in a span issue as one fused DMA
    submission. ``seams`` are the memgraph ids at which the straight-line
    executor hands off to the interpreter (the first vertex of every
    nondet region)."""

    order: list[int]
    instrs: list[Instr]
    regions: list[Region]
    batches: list[tuple[int, int]]
    policy_name: str
    certified: bool                    # soundness certificate was ok
    liveness_certified: bool           # liveness certificate was ok
    # the inline-stamping size bound this plan was lowered under
    # (DESIGN.md §17) — verify() re-checks every inline region against it
    seam_threshold: int = DEFAULT_SEAM_THRESHOLD

    @property
    def n_vertices(self) -> int:
        return len(self.order)

    @property
    def n_static(self) -> int:
        return sum(len(r) for r in self.regions if r.kind == STATIC)

    @property
    def n_nondet(self) -> int:
        return sum(len(r) for r in self.regions if r.kind == NONDET)

    @property
    def n_inline(self) -> int:
        return sum(len(r) for r in self.regions
                   if r.kind == NONDET and r.backend == INLINE)

    @property
    def n_threaded(self) -> int:
        return sum(len(r) for r in self.regions
                   if r.kind == NONDET and r.backend == THREADED)

    @property
    def seams(self) -> tuple[int, ...]:
        return tuple(self.order[r.start] for r in self.regions
                     if r.kind == NONDET)

    @property
    def batch_heads(self) -> dict[int, tuple[int, int]]:
        """Batch-head position -> its ``(start, end)`` span."""
        return {a: (a, b) for a, b in self.batches}

    @property
    def fused_map(self) -> dict[int, int]:
        """Member mid -> batch-head mid, for every fused instruction
        (heads map to themselves). The simulator prices non-head members
        without the fixed submission latency
        (:func:`~repro_torch.core.simulate.simulate`'s ``fused=``)."""
        out: dict[int, int] = {}
        for a, b in self.batches:
            head = self.order[a]
            for i in range(a, b):
                out[self.order[i]] = head
        return out

    def summary(self) -> str:
        return (f"compiled[{self.policy_name}]: {self.n_vertices} instrs, "
                f"{self.n_static} static / {self.n_nondet} nondet "
                f"({self.n_inline} inline, {self.n_threaded} threaded) over "
                f"{len(self.regions)} region(s), {len(self.batches)} fused "
                f"DMA batch(es), certified={self.certified}")

    # -- static verification ------------------------------------------------
    def verify(self, mg: MemGraph) -> None:
        """Re-prove the invariants the executor relies on; raises
        :class:`PlanCompileError` on any violation.

        * the linear order is a permutation of the memgraph;
        * tick counts: ``ready_tick == 1 + max(pos of preds)`` and
          ``ready_tick <= pos`` (the order is topological — position
          order implies dependency order);
        * regions partition ``[0, n)`` contiguously;
        * backend stamps: every nondet region carries ``inline`` or
          ``threaded``; static regions carry none; an inline region fits
          ``seam_threshold``, and — when the plan is not
          liveness-certified — contains no admission vertex (OFFLOAD /
          SPILL / LOAD), the vacuous face of the §17 soundness argument;
        * every batch is a contiguous span of one static region, all
          members share one (device, engine) DMA stream — or, on a
          liveness-certified plan, one device's H2D/D2H *engine pair* —
          and every member's out-of-batch predecessor precedes the
          batch head.
        """
        n = len(self.order)
        if sorted(self.order) != sorted(mg.vertices):
            raise PlanCompileError("linear order is not a permutation of "
                                   "the memgraph vertices")
        pos = {m: i for i, m in enumerate(self.order)}
        for ins in self.instrs:
            want = max((pos[p] + 1 for p in mg.preds[ins.mid]), default=0)
            if ins.ready_tick != want:
                raise PlanCompileError(
                    f"instr {ins.mid}@{ins.pos}: ready_tick "
                    f"{ins.ready_tick} != {want}")
            if ins.ready_tick > ins.pos:
                raise PlanCompileError(
                    f"instr {ins.mid}@{ins.pos}: not topological "
                    f"(ready_tick {ins.ready_tick})")
        at = 0
        for r in self.regions:
            if r.start != at or r.end <= r.start:
                raise PlanCompileError(f"regions do not partition the "
                                       f"order at {at}: {r}")
            at = r.end
            if r.kind == NONDET:
                if r.backend not in (INLINE, THREADED):
                    raise PlanCompileError(
                        f"nondet region {r} has no seam-backend stamp")
                if r.backend == INLINE:
                    if len(r) > self.seam_threshold:
                        raise PlanCompileError(
                            f"inline region {r} exceeds seam_threshold "
                            f"{self.seam_threshold}")
                    if not self.liveness_certified and any(
                            mg.vertices[self.order[i]].op in
                            (MemOp.OFFLOAD, MemOp.SPILL, MemOp.LOAD)
                            for i in range(r.start, r.end)):
                        raise PlanCompileError(
                            f"inline region {r} contains admission "
                            f"vertices on an uncertified-liveness plan — "
                            f"the calling thread could block (§17)")
            elif r.backend:
                raise PlanCompileError(
                    f"static region {r} carries a seam-backend stamp")
        if self.regions and at != n:
            raise PlanCompileError(f"regions end at {at}, order has {n}")
        region_of = [r for r in self.regions for _ in range(len(r))]
        for a, b in self.batches:
            if b - a < 2:
                raise PlanCompileError(f"batch ({a},{b}) has <2 members")
            head = mg.vertices[self.order[a]]
            key = engine_key(head)
            if key[1] not in TRANSFER_KINDS:
                raise PlanCompileError(f"batch ({a},{b}) head is not a "
                                       f"DMA instruction ({key[1]})")
            if region_of[a].kind != STATIC or region_of[b - 1] is not \
                    region_of[a]:
                raise PlanCompileError(
                    f"batch ({a},{b}) crosses a region boundary or sits "
                    f"in a nondet region")
            kinds = {engine_key(mg.vertices[self.order[i]])
                     for i in range(a, b)}
            if len(kinds) > 1:
                # one legal mixture: the H2D/D2H engine pair of one
                # device, and only on a liveness-certified plan (the
                # paired submission holds both DMA lanes behind one
                # completion wait — known stall-free only under §14)
                if not ({k for _, k in kinds} <= {H2D, D2H}
                        and len({d for d, _ in kinds}) == 1
                        and self.liveness_certified):
                    raise PlanCompileError(
                        f"batch ({a},{b}) mixes streams: "
                        f"{sorted(kinds)}")
            for i in range(a, b):
                for p in mg.preds[self.order[i]]:
                    if a <= pos[p] < i:
                        continue       # in-batch: stream FIFO preserves it
                    if pos[p] >= a:
                        raise PlanCompileError(
                            f"batch ({a},{b}): member {self.order[i]} "
                            f"depends on {p}@{pos[p]} which is not "
                            f"complete when the batch issues")


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------
def _timing_sensitive(mg: MemGraph) -> dict[int, bool]:
    """A vertex is timing-sensitive when its launch order can respond to a
    real-time transfer completion: it is a byte-moving transfer itself, or
    it is directly fed by one (its readiness instant *is* a transfer's
    completion instant)."""
    moves = {m: (engine_of(v) in TRANSFER_KINDS and v.nbytes > 0)
             for m, v in mg.vertices.items()}
    return {m: (moves[m] or any(moves[p] for p in mg.preds[m]))
            for m in mg.vertices}


def _segment(mg: MemGraph, order: list[int], *,
             merge_gap: int) -> list[Region]:
    """Replay the linearization, marking every position at which a
    nondeterministic window is open: ≥2 timing-sensitive vertices
    simultaneously ready on the same (device, engine class). Maximal
    marked spans (merged across static slivers shorter than
    ``merge_gap``) become nondet regions."""
    verts = mg.vertices
    ts = _timing_sensitive(mg)
    remaining = {m: len(mg.preds[m]) for m in verts}
    ready_ts: dict[tuple[int, str], int] = {}
    hot = 0                            # engine keys with >=2 ready ts verts

    def bump(m: int, delta: int) -> None:
        nonlocal hot
        if not ts[m]:
            return
        v = verts[m]
        key = engine_key(v)
        was = ready_ts.get(key, 0)
        now = was + delta
        ready_ts[key] = now
        if was < 2 <= now:
            hot += 1
        elif now < 2 <= was:
            hot -= 1

    for m, r in remaining.items():
        if r == 0:
            bump(m, +1)
    mark = [False] * len(order)
    for i, m in enumerate(order):
        mark[i] = hot > 0
        bump(m, -1)
        for s in mg.succs[m]:
            remaining[s] -= 1
            if remaining[s] == 0:
                bump(s, +1)

    # merge: a static sliver shorter than merge_gap between two nondet
    # spans is absorbed (each seam pays a thread-fleet spin-up)
    spans: list[list[int]] = []        # [start, end) of marked runs
    i = 0
    n = len(order)
    while i < n:
        if mark[i]:
            j = i
            while j < n and mark[j]:
                j += 1
            if spans and i - spans[-1][1] < merge_gap:
                spans[-1][1] = j
            else:
                spans.append([i, j])
            i = j
        else:
            i += 1

    regions: list[Region] = []
    at = 0
    for a, b in spans:
        if b - a == 1:
            # a window that admits exactly one position has exactly one
            # execution order — interpreting a 1-element subset recovers
            # the same straight-line step, so keep it static
            continue
        if a > at:
            regions.append(Region(STATIC, at, a))
        regions.append(Region(NONDET, a, b))
        at = b
    if at < n:
        regions.append(Region(STATIC, at, n))
    if not regions and n:
        regions.append(Region(STATIC, 0, n))
    return regions


def _fuse(mg: MemGraph, order: list[int], regions: list[Region], *,
          liveness_ok: bool, max_fuse: int) -> list[tuple[int, int]]:
    """Maximal runs of adjacent same-(device, engine) DMA instructions
    inside static regions; see the module docstring for the legality
    argument. Disk-engine runs require the liveness certificate — and so
    does fusing *across* one device's H2D/D2H engine pair (a paired
    submission holds both DMA lanes of the device behind a single
    completion wait; §14's proof is what makes that wait known
    stall-free). In-batch order is preserved either way: a fused span
    issues back-to-back in position order."""

    def fuse_key(m: int) -> tuple[int, str] | None:
        d, eng = engine_key(mg.vertices[m])
        if eng not in TRANSFER_KINDS:
            return None
        if eng == DISK and not liveness_ok:
            return None
        if liveness_ok and eng in (H2D, D2H):
            return (d, "h2d|d2h")      # the device's DMA engine pair
        return (d, eng)

    batches: list[tuple[int, int]] = []
    for r in regions:
        if r.kind != STATIC:
            continue
        i = r.start
        while i < r.end:
            key = fuse_key(order[i])
            if key is None:
                i += 1
                continue
            j = i + 1
            while j < r.end and j - i < max_fuse:
                if fuse_key(order[j]) != key:
                    break
                j += 1
            if j - i >= 2:
                batches.append((i, j))
            i = j
    return batches


def _ready_width(mg: MemGraph, mids: Sequence[int]) -> int:
    """The widest simultaneously-ready set a seam exposes, replaying its
    members in linearization order with out-of-seam predecessors treated
    as complete — the concurrency the threaded fleet could actually
    exploit. A seam this narrow (≤ MAX_INLINE_WIDTH) gains little from
    real streams, so it is a candidate for the inline backend."""
    subset = set(mids)
    remaining = {m: sum(1 for p in mg.preds[m] if p in subset)
                 for m in mids}
    ready = {m for m, r in remaining.items() if r == 0}
    width = len(ready)
    for m in mids:
        ready.discard(m)
        for s in mg.succs[m]:
            if s in remaining:
                remaining[s] -= 1
                if remaining[s] == 0:
                    ready.add(s)
        width = max(width, len(ready))
    return width


def _stamp_backends(mg: MemGraph, order: list[int],
                    regions: list[Region], *, seam_threshold: int,
                    lcert: LivenessCertificate | None) -> list[Region]:
    """Stamp every NONDET region with its seam backend (DESIGN.md §17):
    ``inline`` when the region is small (≤ ``seam_threshold``), narrow
    (ready width ≤ MAX_INLINE_WIDTH), and the no-blocking-waits claim is
    certified (:func:`~repro_torch.core.liveness.inline_seam_certified`) —
    otherwise it demotes to ``threaded``."""
    out: list[Region] = []
    for r in regions:
        if r.kind != NONDET:
            out.append(r)
            continue
        mids = order[r.start:r.end]
        backend = THREADED
        if (len(r) <= seam_threshold
                and _ready_width(mg, mids) <= MAX_INLINE_WIDTH
                and inline_seam_certified(mg, mids, lcert)):
            backend = INLINE
        out.append(dataclasses.replace(r, backend=backend))
    return out


def lower(res: "BuildResult", *,
          policy: str | DispatchPolicy | None = None,
          seed: int | None = None,
          n_streams: int = 5, n_transfer_streams: int = 1,
          merge_gap: int = DEFAULT_MERGE_GAP,
          max_fuse: int = MAX_FUSE,
          seam_threshold: int | None = None) -> CompiledPlan:
    """Lower ``res`` under ``policy`` into a :class:`CompiledPlan`.

    Uses ``res.certificate`` when the build carried one
    (``BuildConfig.certify``); otherwise the soundness certifier runs
    here (race-freedom and tier coherence for all orders — the property
    that lets static regions drop runtime dispatch entirely). A plan
    that cannot be certified lowers to one whole-plan nondet region.
    ``res.liveness_certificate`` (when present and ok) additionally
    enables fusing disk-engine runs and the H2D/D2H pair.

    ``seam_threshold`` bounds inline-backend stamping (DESIGN.md §17);
    ``None`` defers to ``res.seam_threshold`` (``BuildConfig``'s knob)
    and then :data:`DEFAULT_SEAM_THRESHOLD`."""
    mg = res.memgraph
    pol = get_policy(policy, seed=seed)
    pol.prepare(mg)
    verts = mg.vertices
    if seam_threshold is None:
        seam_threshold = getattr(res, "seam_threshold", None)
    if seam_threshold is None:
        seam_threshold = DEFAULT_SEAM_THRESHOLD

    order = mg.topo_order(
        key=lambda m: (pol.priority(m), verts[m].seq, m))
    pos = {m: i for i, m in enumerate(order)}

    cert = res.certificate
    if cert is None:
        cert = certify(mg)
    certified = bool(getattr(cert, "ok", False))
    lcert = res.liveness_certificate
    liveness_ok = bool(lcert is not None and getattr(lcert, "ok", False))

    if certified and order:
        regions = _segment(mg, order, merge_gap=merge_gap)
    elif order:
        # uncertified: the interpreter keeps full freedom over the plan
        regions = [Region(NONDET, 0, len(order))]
    else:
        regions = []
    regions = _stamp_backends(mg, order, regions,
                              seam_threshold=seam_threshold, lcert=lcert)
    batches = _fuse(mg, order, regions, liveness_ok=liveness_ok,
                    max_fuse=max_fuse)
    head_of: dict[int, int] = {}
    for a, b in batches:
        for i in range(a, b):
            head_of[i] = a

    region_idx = [ri for ri, r in enumerate(regions)
                  for _ in range(len(r))]
    streams: dict[tuple[int, str], int] = {}
    instrs: list[Instr] = []
    for i, m in enumerate(order):
        v = verts[m]
        eng = engine_of(v)
        key = (v.device, eng)
        width = n_streams if eng == COMPUTE else n_transfer_streams
        s = streams.get(key, 0)
        streams[key] = (s + 1) % max(width, 1)
        instrs.append(Instr(
            mid=m, pos=i, device=v.device, engine=eng, stream=s,
            ready_tick=max((pos[p] + 1 for p in mg.preds[m]), default=0),
            region=region_idx[i], batch=head_of.get(i, i)))

    plan = CompiledPlan(order=order, instrs=instrs, regions=regions,
                        batches=batches, policy_name=pol.name,
                        certified=certified, liveness_certified=liveness_ok,
                        seam_threshold=seam_threshold)
    plan.verify(mg)
    return plan


# ---------------------------------------------------------------------------
# CLI: lower + replay the seeded example-plan corpus (CI fast lane)
# ---------------------------------------------------------------------------
def main(argv: Sequence[str] | None = None) -> int:
    import random as pyrandom

    import numpy as np
    import torch

    from .analyze import _corpus_taskgraph
    from .build import BuildConfig, MemgraphOOM, build_memgraph
    from .dispatch import POLICY_NAMES
    from .liveness import certify_progress, default_pool_config
    from .runtime import TurnipRuntime, eval_taskgraph, run_in_order

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.compile",
        description="Lower the seeded example-plan corpus under every "
                    "dispatch policy: each certified plan must lower, "
                    "verify, and replay byte-exactly (DESIGN.md §15).")
    p.add_argument("--seeds", type=int, default=24,
                   help="corpus size (default 24)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print one summary line per plan")
    p.add_argument("--device", default=None,
                   help="where the replays run (default cuda; 'cpu' runs "
                        "them with plain torch ops)")
    args = p.parse_args(argv)
    device = args.device

    def same(a, b) -> bool:
        return torch.equal(a.cpu(), b.cpu())

    host_caps = (None, 1, 2, 3)
    disk_caps = (None, 0, 2, 4, 50)
    n_ok = n_oom = failed = 0
    total_static = total_nondet = total_batches = 0
    total_inline = total_threaded = 0
    for seed in range(args.seeds):
        rng = pyrandom.Random(1000 + seed)
        tg = _corpus_taskgraph(rng)
        host_cap = rng.choice(host_caps)
        disk_cap = rng.choice(disk_caps) if host_cap is not None else None
        cfg = BuildConfig(capacity=3, host_capacity=host_cap,
                          disk_capacity=disk_cap, rng_seed=seed,
                          size_fn=lambda v: 1, backend="compiled")
        try:
            res = build_memgraph(tg, cfg)
        except MemgraphOOM:
            n_oom += 1
            if args.verbose:
                print(f"seed {seed}: rejected at compile time (OOM)")
            continue
        # attach a liveness certificate when the proof goes through, so
        # the corpus also exercises disk-engine fusion (gated on it)
        try:
            lcert = certify_progress(
                res.memgraph,
                default_pool_config(cfg.host_budget()),
                disk_capacity=cfg.disk_capacity)
            if lcert.ok:
                res.liveness_certificate = lcert
        except Exception:
            pass
        inputs = {t: np.random.default_rng(seed).integers(
                      -3, 4, v.out.shape).astype(np.float64)
                  for t, v in tg.vertices.items()
                  if v.kind.value == "input"}
        ref = eval_taskgraph(tg, inputs, device=device)
        bad = False
        for pol_name in POLICY_NAMES:
            try:
                plan = lower(res, policy=pol_name, seed=seed)
                # the linearization itself must be a valid schedule
                out = run_in_order(tg, res, inputs, plan.order,
                                   device=device)
                for k in ref:
                    if not same(out[k], ref[k]):
                        raise PlanCompileError(
                            f"linearization replay diverged on output {k}")
                # every nondet region must carry a seam-backend stamp
                # (DESIGN.md §17); plan.verify() enforces the inline
                # soundness conditions on top
                for r in plan.regions:
                    if r.kind == NONDET and r.backend not in (INLINE,
                                                              THREADED):
                        raise PlanCompileError(
                            f"unstamped nondet region {r}")
                total_static += plan.n_static
                total_nondet += plan.n_nondet
                total_inline += plan.n_inline
                total_threaded += plan.n_threaded
                total_batches += len(plan.batches)
            except Exception as e:
                print(f"seed {seed}/{pol_name}: FAILED ({e})")
                bad = True
        # the full compiled executor (straight-line + seam backends),
        # under the compiler's stamps and with every seam forced inline
        for seam_backend in ("auto", INLINE):
            try:
                rr = TurnipRuntime(tg, res, mode="nondet",
                                   policy="critical-path", seed=seed,
                                   seam_backend=seam_backend,
                                   device=device).run(inputs)
                for k in ref:
                    if not same(rr.outputs[k], ref[k]):
                        raise PlanCompileError(
                            f"compiled executor diverged on output {k}")
                assert rr.n_compiled + rr.n_interpreted == \
                    len(res.memgraph.vertices)
                assert rr.n_inline + rr.n_threaded == rr.n_interpreted
                if seam_backend == INLINE:
                    assert rr.n_threaded == 0
            except Exception as e:
                print(f"seed {seed}/executor[{seam_backend}]: "
                      f"FAILED ({e})")
                bad = True
        if bad:
            failed += 1
        else:
            n_ok += 1
            if args.verbose:
                print(f"seed {seed}: ok ({plan.summary()})")
    print(f"corpus: {n_ok} plans lowered + replayed byte-exactly, "
          f"{n_oom} rejected at compile time, {failed} failed; "
          f"{total_static} static / {total_nondet} nondet instrs "
          f"({total_inline} inline, {total_threaded} threaded), "
          f"{total_batches} fused batches across all policies")
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
