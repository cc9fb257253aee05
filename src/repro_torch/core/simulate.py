"""Discrete-event simulator for MEMGRAPH execution (paper §2/§8 ablation).

The model behind the paper's headline effect (the GPU stalls while a
transfer finishes), copied from the reference and held to *simulation
equality*: the same memgraph and :class:`HardwareModel` give the same
:class:`SimResult` in both packages. Each device has a compute engine plus
three DMA channels (host→device, device→host, device→device) and a disk
I/O engine (host↔disk spills/loads of the tiered hierarchy, DESIGN.md §10)
that run concurrently — the concurrency structure of CUDA streams and
``cudaMemcpyAsync``. Durations come from a :class:`HardwareModel`: the
defaults are the paper's P100 server, and :data:`H100_MEASURED` holds the
constants ``chip_smoke.py`` measured on one H100, so simulated makespans
can be set beside the port's measured ones.

Two dispatch modes reproduce the paper's ablation (§8, "Fixed execution"):

* ``nondet`` — the TURNIP event loop: any vertex whose deps are complete is
  launched as soon as its engine frees up; *which* queued vertex an engine
  picks is ranked by a :class:`~repro_torch.core.dispatch.DispatchPolicy` — the
  same vocabulary the threaded :class:`~repro_torch.core.runtime.TurnipRuntime`
  uses, so simulated and real-thread schedules are comparable;
* ``fixed``  — vertices are *launched* strictly in the compile-time
  simulation order; a launched vertex still executes asynchronously on its
  engine, but no later vertex may launch before it (head-of-line blocking —
  exactly what makes a fixed order stall on unpredictable transfers).

Outputs makespan + per-device compute busy/stall, the quantities behind the
paper's Figures 10–15 and its ≤3× fixed-order slowdown claim.
"""
from __future__ import annotations

import dataclasses
import heapq

from .dispatch import (COMPUTE as _COMPUTE, D2D as _D2D, D2H as _D2H,
                       DISK as _DISK, DispatchPolicy, ENGINE_OF as _ENGINE_OF,
                       H2D as _H2D, NIC as _NIC,
                       TRANSFER_KINDS as _TRANSFER_KINDS,
                       get_policy)
from .memgraph import DepKind, MemGraph, MemOp, MemVertex

__all__ = ["HardwareModel", "H100_MEASURED", "SimResult", "simulate",
           "price_migration", "price_reprefill", "migration_crossover"]


@dataclasses.dataclass
class HardwareModel:
    """Latency/bandwidth constants. Defaults ≈ the paper's P100 server
    figures (PCIe gen3 x16 ≈ 12 GB/s, fp16 ≈ 18.7 TFLOP/s but sliced
    kernels reach a fraction of peak), kept as the reference has them;
    :data:`H100_MEASURED` is the port's card."""

    flops: float = 8e12              # effective FLOP/s per device
    hbm_bw: float = 500e9            # bytes/s — memory-bound floor for kernels
    h2d_bw: float = 12e9
    d2h_bw: float = 12e9
    d2d_bw: float = 12e9
    disk_bw: float = 2.4e9           # host<->disk tier (NVMe-class)
    nic_bw: float = 3.1e9            # host<->remote-host (25 GbE-class) —
    #                                  the sixth priced channel: inter-replica
    #                                  KV migration (serve/router.py)
    kernel_overhead: float = 5e-6    # fixed per-kernel launch cost (s)
    dma_latency: float = 10e-6       # fixed per-transfer cost (s)
    disk_latency: float = 100e-6     # fixed per disk spill/load cost (s)
    nic_latency: float = 50e-6       # fixed per inter-replica transfer (s)
    # The paper's core hypothesis (§2): offload/reload latencies are
    # "seemingly nondeterministic". jitter is the sigma of a lognormal
    # multiplier on transfer durations (0 = deterministic). The same seeded
    # per-vertex draw is used in both dispatch modes (common random numbers)
    # so fixed-vs-nondet comparisons are paired.
    transfer_jitter: float = 0.0
    compute_jitter: float = 0.0
    # Shared-pool contention (DESIGN.md §12): when the host arena is an
    # arbitrated HostPool, another consumer's pressure can revoke this
    # plan's slack mid-flight, turning a host-resident staging into a
    # re-stage from disk. pool_contention is the probability a disk-tier
    # op hits a revoked extent and pays revoke_stall extra seconds — a
    # seeded per-vertex Bernoulli draw (common random numbers, like the
    # jitter), so fixed-vs-nondet and pooled-vs-isolated comparisons are
    # paired. 0 (default) prices an isolated pool exactly as before.
    pool_contention: float = 0.0
    revoke_stall: float = 500e-6
    seed: int = 0

    def duration(self, v: MemVertex, *, fused: bool = False) -> float:
        """Execution seconds of ``v``. ``fused=True`` prices a non-head
        member of a fused DMA batch (core/compile.py): the submission
        rides its batch head's enqueue, so the fixed per-transfer latency
        term (``dma_latency``/``disk_latency``) is dropped and only the
        wire time remains — one launch cost per batch, paid by the head.
        Jitter stays per-vertex so fused-vs-unfused comparisons are
        common-random-numbers paired."""
        eng = _ENGINE_OF[v.op]
        if v.op == MemOp.JOIN:
            return 0.0
        if eng == _COMPUTE:
            t_flops = v.flops / self.flops
            t_mem = 3.0 * v.nbytes / self.hbm_bw   # read 2 operands + write
            base = self.kernel_overhead + max(t_flops, t_mem)
            return base * self._jit(v.mid, self.compute_jitter)
        if eng == _DISK:
            if v.nbytes == 0:          # dedup/drop spill: no bytes move
                return 0.0
            # same paired per-vertex jitter draw as the DMA lanes, so
            # fixed-vs-nondet comparisons stay common-random-numbers even
            # when the nondeterminism source is the disk tier
            base = (0.0 if fused else self.disk_latency) \
                + v.nbytes / self.disk_bw
            base += self._revoked(v.mid) * self.revoke_stall
            return base * self._jit(v.mid, self.transfer_jitter)
        if eng == _NIC:
            # same paired jitter stream as the other transfer channels —
            # the inter-replica wire is priced like any DMA lane, with its
            # own latency/bandwidth constants (arXiv 2502.15712's stance)
            base = (0.0 if fused else self.nic_latency) \
                + v.nbytes / self.nic_bw
            return base * self._jit(v.mid, self.transfer_jitter)
        bw = {_H2D: self.h2d_bw, _D2H: self.d2h_bw, _D2D: self.d2d_bw}[eng]
        base = (0.0 if fused else self.dma_latency) + v.nbytes / bw
        return base * self._jit(v.mid, self.transfer_jitter)

    def _jit(self, mid: int, sigma: float) -> float:
        if sigma <= 0.0:
            return 1.0
        import math
        import random
        r = random.Random((self.seed << 20) ^ mid)
        return math.exp(r.gauss(0.0, sigma) - sigma * sigma / 2.0)

    def _revoked(self, mid: int) -> int:
        """Paired per-vertex draw: does this disk op hit a revoked extent?
        (Distinct stream from the jitter draw so enabling contention never
        reshuffles the jitter multipliers.)"""
        if self.pool_contention <= 0.0:
            return 0
        import random
        r = random.Random((self.seed << 21) ^ (mid * 2654435761))
        return int(r.random() < self.pool_contention)


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: dict[int, float]           # per device: compute-engine busy seconds
    stall: dict[int, float]          # per device: makespan - busy
    transfer_time: dict[str, float]  # per channel kind: total busy seconds
    n_vertices: int
    timeline: list[tuple[float, float, int, str, str]]  # t0,t1,dev,engine,name
    # per-vertex launch/completion instants: the simulator's schedule as
    # data, so a differential harness can *replay* exactly the order the
    # simulator chose through the sequential interpreter (topo_order keyed
    # by start_at) and prove it byte-exact against the oracle
    start_at: dict[int, float] = dataclasses.field(default_factory=dict)
    done_at: dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def total_stall(self) -> float:
        return sum(self.stall.values())


def simulate(mg: MemGraph, hw: HardwareModel | None = None, *,
             mode: str = "nondet",
             policy: str | DispatchPolicy | None = "fixed",
             record_timeline: bool = False,
             fused: dict[int, int] | None = None) -> SimResult:
    """Simulate one execution of ``mg`` under ``hw``; see module docstring.

    ``policy`` ranks the ready vertices queued on each engine in ``nondet``
    mode (default ``fixed`` = compile-order tie-break, the conservative
    baseline); it is ignored in ``fixed`` mode, which bypasses the ready
    queues entirely.

    ``fused`` prices the compiled backend's batched DMA submissions
    (DESIGN.md §15): a ``CompiledPlan.fused_map`` (member mid → batch-head
    mid). Non-head members ride the head's enqueue, so they skip the
    fixed per-transfer latency term; dependency structure is unchanged —
    fusion is a submission-cost optimisation, not a reordering.
    """
    hw = hw or HardwareModel()
    if mode not in ("nondet", "fixed"):
        raise ValueError(mode)
    # cost-aware policies rank by *this* machine's durations (jitter
    # included — it is deterministic per vertex), not the generic estimate.
    pol = get_policy(policy, seed=hw.seed, cost_fn=hw.duration)
    pol.prepare(mg)

    verts = mg.vertices
    devices = sorted({v.device for v in verts.values()})
    engines = [(d, k) for d in devices
               for k in (_COMPUTE, _H2D, _D2H, _D2D, _DISK, _NIC)]
    free_at = {e: 0.0 for e in engines}
    queue: dict[tuple[int, str], list] = {e: [] for e in engines}  # ready heaps
    remaining = {m: len(mg.preds[m]) for m in verts}
    launched: set[int] = set()
    done_at: dict[int, float] = {}
    events: list[tuple[float, int]] = []   # (completion time, mid)
    timeline: list[tuple[float, float, int, str, str]] = []
    busy = {d: 0.0 for d in devices}
    chan = {k: 0.0 for k in _TRANSFER_KINDS}

    by_seq = sorted(verts, key=lambda m: verts[m].seq)
    seq_ready: dict[int, float] = {}       # mid -> time deps completed
    next_issue = 0                          # fixed mode pointer into by_seq
    start_at: dict[int, float] = {}

    def engine_of(m: int) -> tuple[int, str]:
        v = verts[m]
        return (v.device, _ENGINE_OF[v.op])

    def start(m: int, now: float) -> None:
        e = engine_of(m)
        v = verts[m]
        t0 = max(now, free_at[e])
        dur = hw.duration(v, fused=fused is not None
                          and fused.get(m, m) != m)
        t1 = t0 + dur
        free_at[e] = t1
        start_at[m] = t0
        if e[1] == _COMPUTE:
            busy[v.device] += dur
        else:
            chan[e[1]] += dur
        if record_timeline:
            timeline.append((t0, t1, v.device, e[1], v.name or str(m)))
        heapq.heappush(events, (t1, m))
        launched.add(m)

    def on_ready(m: int, now: float) -> None:
        if mode == "fixed":
            seq_ready[m] = now
            return
        heapq.heappush(queue[engine_of(m)],
                       (pol.priority(m), verts[m].seq, m))

    def drain(now: float) -> None:
        if mode == "fixed":
            nonlocal next_issue
            while next_issue < len(by_seq) and by_seq[next_issue] in seq_ready:
                start(by_seq[next_issue], now)
                next_issue += 1
            return
        for e in engines:
            q = queue[e]
            while q and free_at[e] <= now:
                _, _, m = heapq.heappop(q)
                start(m, now)
            # engine busy past `now`: leave rest queued; they start when the
            # engine's current op completes (handled on that event)

    now = 0.0
    for m, r in remaining.items():
        if r == 0:
            on_ready(m, 0.0)
    drain(0.0)
    while events:
        now, m = heapq.heappop(events)
        if m in done_at:
            continue
        done_at[m] = now
        for s in mg.succs[m]:
            remaining[s] -= 1
            if remaining[s] == 0:
                on_ready(s, now)
        drain(now)
        # engines that just freed may have queued work
        if mode == "nondet":
            for e in engines:
                q = queue[e]
                while q and free_at[e] <= now:
                    _, _, mm = heapq.heappop(q)
                    start(mm, now)

    if len(done_at) != len(verts):
        raise AssertionError("simulation deadlocked — memgraph not runnable")
    makespan = now
    stall = {d: makespan - busy[d] for d in devices}
    return SimResult(makespan=makespan, busy=busy, stall=stall,
                     transfer_time=chan, n_vertices=len(verts),
                     timeline=sorted(timeline),
                     start_at=start_at, done_at=done_at)


# -- migration vs re-prefill pricing (serve/router.py, DESIGN.md §16) -------
# When a replica dies, every in-flight request must land on a survivor in
# one of two ways: *migrate* its host/disk-resident KV blocks over the NIC
# (warm) or *re-prefill* its prompt + emitted tokens from scratch (cold).
# Both paths are priced through `simulate()` on purpose-built micro-plans so
# the prediction shares the channel model (latencies, bandwidths, jitter)
# with every other figure instead of a parallel analytic formula.

def price_migration(hw: HardwareModel | None = None, *,
                    n_blocks: int,
                    block_nbytes: int,
                    disk_blocks: int = 0) -> float:
    """Predicted seconds to warm-migrate one request's KV state and make it
    decode-ready on the destination: per block, an optional disk LOAD (for
    the ``disk_blocks`` blocks resident on the source's disk tier at
    migration time), the NIC XFER, then the destination's h2d RELOAD. The
    three stages run on three independent engines, so the micro-plan
    pipelines exactly like the real transfer streams do."""
    hw = hw or HardwareModel()
    if not 0 <= disk_blocks <= n_blocks:
        raise ValueError(f"disk_blocks={disk_blocks} not in [0, {n_blocks}]")
    mg = MemGraph()
    seq = 0
    for b in range(n_blocks):
        prev = None
        stages = ([MemOp.LOAD] if b < disk_blocks else []) \
            + [MemOp.XFER, MemOp.RELOAD]
        for op in stages:
            m = mg.add_vertex(op, 0, nbytes=block_nbytes, seq=seq,
                              name=f"{op.value}:blk{b}")
            seq += 1
            if prev is not None:
                mg.add_dep(prev, m, DepKind.DATA)
            prev = m
    return simulate(mg, hw).makespan


def price_reprefill(hw: HardwareModel | None = None, *,
                    tokens: int,
                    flops_per_token: float,
                    kv_nbytes: int = 0) -> float:
    """Predicted seconds to cold-resume one request by re-prefilling its
    prompt plus already-emitted tokens on the destination (one batched
    prefill kernel; the KV bytes are produced on-device as a side effect,
    so no transfer channel is touched)."""
    hw = hw or HardwareModel()
    mg = MemGraph()
    mg.add_vertex(MemOp.COMPUTE, 0, flops=tokens * flops_per_token,
                  nbytes=kv_nbytes, seq=0, name=f"reprefill:{tokens}tok")
    return simulate(mg, hw).makespan


def migration_crossover(hw: HardwareModel | None = None, *,
                        block_size: int,
                        block_nbytes: int,
                        flops_per_token: float,
                        n_blocks_sweep: "list[int] | None" = None,
                        disk_frac: float = 0.0) -> list[dict]:
    """Sweep request sizes and report, per size, whether warm migration
    beats cold re-prefill on this hardware — the router's eviction-choice
    table and the BENCH crossover rows. ``disk_frac`` is the fraction of
    the request's blocks sitting on the source's disk tier at kill time."""
    hw = hw or HardwareModel()
    rows = []
    for nb in (n_blocks_sweep or [1, 2, 4, 8, 16, 32, 64]):
        tokens = nb * block_size
        t_mig = price_migration(hw, n_blocks=nb, block_nbytes=block_nbytes,
                                disk_blocks=int(round(nb * disk_frac)))
        t_pre = price_reprefill(hw, tokens=tokens,
                                flops_per_token=flops_per_token,
                                kv_nbytes=nb * block_nbytes)
        rows.append({
            "n_blocks": nb,
            "tokens": tokens,
            "migrate_s": t_mig,
            "reprefill_s": t_pre,
            "winner": "migrate" if t_mig <= t_pre else "reprefill",
        })
    return rows


# One NVIDIA H100 80GB HBM3 at a 700.00 W power limit, as `chip_smoke.py`
# measured it (PERF.md §6), medians of CUDA-event timings: h2d and
# d2h of a pinned 256 MiB copy (5.1389 and 4.8716 ms); hbm_bw from a 1 GiB
# copy inside HBM, bytes read plus written (0.7346 ms), as the model
# charges a vertex 3 x nbytes; flops from the prefill's largest matmul
# vertex, [2048, 4096] x [4096, 5504] float16 (9.234e10 flop, 0.1868 ms);
# kernel_overhead and dma_latency from an empty launch and a 4 KiB pinned
# copy issued to an idle stream, so they hold the launch's path from the
# host too. d2d_bw is not measured (one card has no second device to copy
# to), nor are the disk and NIC figures: they keep the defaults.
H100_MEASURED = HardwareModel(
    flops=494.208e12, hbm_bw=2.9235e12, h2d_bw=52.236e9, d2h_bw=55.102e9,
    kernel_overhead=17.376e-6, dma_latency=21.984e-6)
