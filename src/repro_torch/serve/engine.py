"""Continuous-batching serving engine with block-paged KV-cache offload.

The port of ``repro/serve/engine.py``. TURNIP executes *static* graphs, so
recursive generation runs over a small set of fixed shapes:

* **Request queue → bucketed static batches.** Requests are admitted into
  fixed batch *slots*; every decode step runs ``decode_step`` over
  ``[bucket, 1]`` tokens with per-row cache positions. Rows at different
  depths share one step (continuous batching); slots without a live
  request are *inert* — ``decode_step``'s ``active`` mask keeps them from
  writing to the cache, and their logits are never sampled.
* **Batched prefill.** A prompt enters the cache through ONE forward
  (:meth:`~repro_torch.models.lm.LM.prefill`); the request's first token
  samples from the prefill logits.
* **MEMGRAPH memory discipline.** The KV cache is a
  :class:`~repro_torch.serve.kv_cache.PagedKVCache`: block-granular static
  extents over a preallocated cache. Cold blocks are *mirrored* to the
  :class:`~repro_torch.core.stores.HostStore` on a d2h stream, and
  swapped-out requests are restored on an h2d stream; decode never blocks
  on a transfer (paper §5). The main loop owns all cache mutation.
* **Nondeterministic reload order.** Which pending transfer a DMA stream
  services next is a :class:`~repro_torch.core.dispatch.DispatchPolicy`
  decision: ``fixed`` replays block-creation order (§8's head-of-line
  pathology), ``critical-path`` completes the request that can resume
  soonest, ``random`` is the any-order-must-work stance.
* **A bounded host tier with disk spill** (``host_kv_bytes``): least
  recently used mirrored blocks spill to the port's file-backed
  :class:`~repro_torch.core.stores.TieredStore` on a dedicated disk
  stream, with two-hop ``disk→host→device`` reloads and predictive
  prefetch of the next swapped requests' blocks.
* **An arbitrated shared host pool** (``pool=HostPool(...)``, DESIGN.md
  §12): every host-bound block is reserved against the engine's ``kv`` or
  ``prefetch`` lease before its transfer is submitted.

What is real on the card. Each DMA thread owns a CUDA stream for its
direction and enters it. A **d2h** service takes the block's device
slices under the engine lock, then, off the lock, makes its stream wait on
the event the main loop recorded on the compute stream after its latest
write to the cache (:meth:`PagedKVCache.mark_written`), copies the block
into pinned host tensors (``HostStore._host_copy``), records an event and
synchronises it (the wait releases the GIL). Only then does it hand the
copy to the store and post completion, so a block's host copy always
holds its final bytes, and a swapped-out slot is zeroed and reused only
after its copies have finished (ROADMAP C3). An **h2d** service copies the
pinned host block into device staging tensors on its own stream,
synchronises, and posts ``("reload", rid, blk, data)``: as in the
reference, only the main loop writes the cache, because an inert row's
decode at position 0 would otherwise race a direct h2d write. The
simulated wire time of ``ServeConfig.h2d_bw``, ``d2h_bw``,
``dma_latency`` and ``disk_bw`` is slept only when the model runs on the
CPU, so the CPU tests go through the reference's interleavings; on CUDA
the wire time is the copy's own.

Sampling at temperature > 0 uses the port's own counter-based schedule
over ``(seed, rid, pos)`` (torch cannot reproduce the reference's
threefry bits): a request's tokens are independent of batch composition,
padding, offload and reload order, and :func:`naive_generate` is the
unbatched oracle any engine configuration must match. Greedy sampling is
the reference's.

The fleet seams (DESIGN.md §16) are the reference's: ``submit(rid=)``
pins a router-allocated id; ``on_step`` beats a heartbeat off the lock;
``hard_kill``, ``fault_after_steps`` and ``pause``/``resume`` are the
fault seams; ``drain_tickets``, ``export_one_swapped`` and
``import_migration`` move requests between replicas as
:class:`MigrationTicket` objects. A warm ticket's blocks are the pinned host
copies of the offload tier, each handed to the store only after its d2h
copy finished, so a ticket never carries a block still in flight; a
killed replica's run loop joins its DMA threads before it returns, and
:meth:`Engine.close` drops its device cache. The reference's fused DMA
submissions (``fuse_dma``), which no test or benchmark turns on, are not
ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time

import numpy as np
import torch

from ..core import lockcheck
from ..core.bridge import dtype_name
from ..core.dispatch import D2H, DISK, H2D, DispatchPolicy
from ..core.executor import select_best
from ..core.liveness import (LeaseSpec, LivenessCertificate,
                             LivenessModelError, PoolConfig,
                             certify_progress)
from ..core.memgraph import MemGraph
from ..core.stores import HostStore, TieredStore
from .kv_cache import PagedKVCache

__all__ = ["ServeConfig", "Engine", "Request", "ServeStats",
           "ReloadPolicy", "RELOAD_POLICY_NAMES", "get_reload_policy",
           "ReplicaKilled", "MigrationRefused", "MigrationTicket",
           "naive_generate"]

# request lifecycle
QUEUED, RUNNING, SWAPPING, SWAPPED, RELOADING, DONE = (
    "queued", "running", "swapping-out", "swapped", "reloading", "done")


class ReplicaKilled(RuntimeError):
    """The replica's run loop was hard-killed (``hard_kill()`` or
    ``fault_after_steps``): device state is gone, but the host/disk tiers,
    owned by the host process, survive for draining."""


class MigrationRefused(RuntimeError):
    """All-or-nothing import refused: the destination could not reserve the
    whole KV set against its lease, or the ticket failed validation.
    Nothing landed; the caller falls back to cold re-prefill."""


@dataclasses.dataclass
class MigrationTicket:
    """A request checkpointed at its last emitted token, portable between
    replicas. ``blocks`` carries the KV payloads of a *warm* ticket (one
    ``{leaf: CPU tensor}`` dict per block, ``read_block``'s layout);
    ``None`` means cold: the destination re-prefills ``prompt + out``,
    token-exact because sampling folds only (seed, rid, position)."""

    rid: int
    prompt: list[int]
    out: list[int]
    max_new: int
    pos: int
    last: int
    block_size: int
    t_submit: float = 0.0
    t_first: float = 0.0
    blocks: "list[dict] | None" = None

    @property
    def warm(self) -> bool:
        return self.blocks is not None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    # the cache grows to the smallest bucket covering demand and stays
    # there: after a burst, decode keeps running the largest bucket with
    # inert rows masked
    batch_buckets: tuple[int, ...] = (1, 4, 8)
    temperature: float = 0.0          # 0 = greedy
    block_size: int = 32              # tokens per KV block (offload extent)
    # ---- offload / swapping ------------------------------------------
    offload: bool = False             # mirror cold KV blocks to host RAM
    hot_window: int = 32              # trailing tokens that never offload
    offload_fraction: float = 1.0     # cap: mirrored fraction of a request
    preempt_every: int = 0            # decode quantum before a running
    #                                   request may be swapped out for a
    #                                   waiter (0 = never preempt)
    reload_policy: str = "critical-path"   # fixed|random|critical-path
    # ---- disk tier ----------------------------------------------------
    # host_kv_bytes bounds the host-RAM KV mirror; past it the engine
    # spills least-recently-used mirrored blocks to a file-backed disk
    # tier on a dedicated disk stream. None = unbounded host.
    host_kv_bytes: int | None = None
    disk_bw: float = 2.4e9
    # stage the next-scheduled swapped requests' disk-resident blocks back
    # into host RAM ahead of their admission (timing only)
    prefetch_swapped: bool = True
    # simulated wire times, slept on the DMA threads only when the model
    # runs on the CPU; on CUDA the copies take their own time
    h2d_bw: float = 12e9
    d2h_bw: float = 12e9
    dma_latency: float = 10e-6
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    state: str = QUEUED
    slot: int = -1
    pos: int = 0                      # tokens resident in the cache
    last: int = 0                     # last sampled token (next decode feed)
    quantum: int = 0                  # decode steps since (re)admission
    mirrored: set[int] = dataclasses.field(default_factory=set)
    inflight: set[int] = dataclasses.field(default_factory=set)
    pending_reload: set[int] = dataclasses.field(default_factory=set)
    reload_data: dict[int, dict] = dataclasses.field(default_factory=dict)
    # time-to-first-token stamps (time.monotonic() seconds), carried across
    # migrations in the ticket
    t_submit: float = 0.0
    t_first: float = 0.0


@dataclasses.dataclass
class ServeStats:
    tokens: int = 0                   # all emitted (incl. prefill-sampled)
    decode_tokens: int = 0            # emitted by decode steps only
    prefill_tokens: int = 0
    prefill_calls: int = 0
    decode_steps: int = 0
    decode_time: float = 0.0
    prefill_time: float = 0.0
    stall_time: float = 0.0           # wall time with no resident row to step
    swaps: int = 0
    revocations: int = 0              # pool grant shrinkages signalled to us
    lease_deferrals: int = 0          # transfers deferred by a refused
    #                                   reservation (shared-pool mode)
    offload_bytes: int = 0
    reload_bytes: int = 0
    disk_spill_bytes: int = 0         # host→disk tier traffic
    disk_load_bytes: int = 0          # disk→host tier traffic
    prefetch_bytes: int = 0           # disk→host bytes staged ahead of a
    #                                   resume (subset of disk_load_bytes)
    kv_bytes_written: int = 0
    migrations_in: int = 0            # warm tickets imported (router fleet)
    migrations_out: int = 0           # warm tickets exported off this
    #                                   replica (live rebalance)

    @property
    def offloaded_fraction(self) -> float:
        return self.offload_bytes / max(self.kv_bytes_written, 1)

    @property
    def decode_tok_s(self) -> float:
        """Decode-step throughput: first tokens (sampled from prefill
        logits during prefill_time) are excluded from the numerator."""
        return self.decode_tokens / max(self.decode_time + self.stall_time,
                                        1e-9)


# --------------------------------------------------------------------------
# DMA transfers + reload-order policies
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Transfer:
    kind: str                         # dispatch.D2H | dispatch.H2D | dispatch.DISK
    rid: int
    blk: int
    seq: int                          # block-creation order
    nbytes: int
    disk_op: str = ""                 # DISK: "spill" | "load" | "prefetch"


class ReloadPolicy(DispatchPolicy):
    """DispatchPolicy over pending serve transfers. Urgency is dynamic (it
    depends on which requests are blocked), so ``priority`` is evaluated
    at pop time under the engine lock."""

    name = "serve-base"

    def prepare(self, engine) -> None:              # type: ignore[override]
        self.engine = engine

    def priority(self, tr: _Transfer) -> float:     # type: ignore[override]
        raise NotImplementedError

    def pick(self, pending: list[_Transfer]) -> _Transfer:
        # the executor kernel's dispatch primitive (DESIGN.md §17): the
        # policy minimum of the simultaneously-ready set
        best = select_best(pending,
                           lambda tr: (self.priority(tr), tr.seq))
        return pending.pop(best)


class FixedReloadPolicy(ReloadPolicy):
    """Strict block-creation order: the predetermined schedule. Blocks of
    concurrently decoding slots turn cold in lockstep, so two swapped
    requests' reloads interleave (§8's head-of-line pathology)."""

    name = "fixed"

    def priority(self, tr: _Transfer) -> float:
        return float(tr.seq)


class RandomReloadPolicy(ReloadPolicy):
    """Seeded uniform-random priority (the any-order-must-work stance)."""

    name = "random"

    def __init__(self, seed: int | None = None) -> None:
        self.seed = random.randrange(2**31) if seed is None else seed

    def priority(self, tr: _Transfer) -> float:
        # integer-only mixing: builtin hash() of strings is salted per
        # process (PYTHONHASHSEED), which would defeat the seed
        ident = (tr.rid * 2654435761 + tr.blk * 40503 + (tr.kind == H2D)
                 + (tr.kind == DISK) * 7919 + (tr.disk_op == "spill") * 104729)
        return random.Random(
            (self.seed * 1000003 + 0x9E3779B9) ^ ident).random()


class CriticalPathReloadPolicy(ReloadPolicy):
    """Complete the request that can resume soonest: fewest outstanding
    transfers first, most remaining decode work as tie-break. On the disk
    stream, loads outrank prefetches, which outrank spills."""

    name = "critical-path"

    def priority(self, tr: _Transfer) -> float:
        req = self.engine.reqs.get(tr.rid)
        if req is None:                    # released mid-flight: drain first
            return -1e12
        if tr.disk_op == "spill":
            return 1e12                    # never ahead of a pending load
        if tr.disk_op == "prefetch":
            return 1e9
        remaining_work = req.max_new - len(req.out)
        return len(req.inflight) * 1e6 - remaining_work


RELOAD_POLICY_NAMES = ("fixed", "random", "critical-path")


def get_reload_policy(policy: str | ReloadPolicy | None, *,
                      seed: int | None = None) -> ReloadPolicy:
    if isinstance(policy, ReloadPolicy):
        return policy
    if policy is None or policy == "critical-path":
        return CriticalPathReloadPolicy()
    if policy == "fixed":
        return FixedReloadPolicy()
    if policy == "random":
        return RandomReloadPolicy(seed)
    raise ValueError(f"unknown reload policy {policy!r}; "
                     f"expected one of {RELOAD_POLICY_NAMES}")


class _DmaStream(threading.Thread):
    """A dedicated transfer engine for one direction.

    Pops the best-ranked pending transfer (the policy's choice), then runs
    the service callback, which does the copy off the engine lock. On
    CUDA the thread runs inside its own CUDA stream (``cuda_stream``; the
    current stream is per thread). With ``simulate`` (a model on the CPU)
    it first sleeps the wire time, as the reference does."""

    def __init__(self, kind: str, bw: float, latency: float,
                 policy: ReloadPolicy, service, lock, *,
                 cuda_stream: torch.cuda.Stream | None = None,
                 simulate: bool = False) -> None:
        super().__init__(name=f"serve-dma-{kind}")
        self.kind = kind
        self.bw = bw
        self.latency = latency
        self.policy = policy
        self.service = service
        self.cuda_stream = cuda_stream
        self.simulate = simulate
        self.pending: list[_Transfer] = []
        self.cond = threading.Condition(lock)
        self.stopped = False
        self.error: BaseException | None = None

    def submit(self, tr: _Transfer) -> None:
        """Engine lock held."""
        self.pending.append(tr)
        self.cond.notify_all()

    def shutdown(self) -> None:
        """Engine lock held. Unserviced transfers are abandoned."""
        self.stopped = True
        self.pending.clear()
        self.cond.notify_all()

    def run(self) -> None:
        ctx = (torch.cuda.stream(self.cuda_stream)
               if self.cuda_stream is not None else contextlib.nullcontext())
        try:
            with ctx:
                while True:
                    with self.cond:
                        while not self.pending and not self.stopped:
                            self.cond.wait()
                        if self.stopped:
                            return
                        tr = self.policy.pick(self.pending)
                    if self.simulate:
                        time.sleep(self.latency + tr.nbytes / self.bw)
                    self.service(tr)
        except BaseException as e:       # surface in the engine loop — a
            with self.cond:              # silently dead stream would wedge
                self.error = e           # every waiter forever
                self.stopped = True
                self.cond.notify_all()


# --------------------------------------------------------------------------
# sampling — shared by the engine and the unbatched oracle
# --------------------------------------------------------------------------
_MASK64 = (1 << 64) - 1


def _sample_seed(seed: int, rid: int, pos: int) -> int:
    """A 63-bit generator seed from (seed, rid, pos): a splitmix64 chain,
    so neighbouring counters give unrelated streams."""
    x = 0
    for word in (seed, rid, pos):
        x = (x ^ (word & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
        x ^= x >> 31
    return x >> 1


def _sample_token(row_logits: np.ndarray, *, seed: int, rid: int, pos: int,
                  temperature: float, vocab_size: int) -> int:
    """The token at absolute position ``pos`` of request ``rid``. Vocab
    padding is masked out. At temperature > 0 a CPU ``torch.Generator``
    seeded from (seed, rid, pos) draws from softmax(row / temperature), so
    a request's randomness is independent of batching and scheduling."""
    row = np.asarray(row_logits[:vocab_size], np.float32)
    if temperature <= 0:
        return int(np.argmax(row))
    gen = torch.Generator().manual_seed(_sample_seed(seed, rid, pos))
    probs = torch.softmax(torch.from_numpy(row).double() / temperature, 0)
    return int(torch.multinomial(probs, 1, generator=gen))


def _to_numpy(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
class Engine:
    """Continuous-batching decode engine over a block-paged KV cache, on
    the model's device."""

    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(), *,
                 host: HostStore | None = None, pool=None,
                 name: str = "serve"):
        """``host``: pass a runtime's :class:`HostStore` (or
        :class:`TieredStore`) to share one pinned host pool with it; by
        default the engine owns a private store — tiered (host + disk) when
        ``cfg.host_kv_bytes`` bounds the KV mirror, plain otherwise.

        ``pool``: a :class:`~repro_torch.core.pool.HostPool` (DESIGN.md
        §12). The engine takes two leases — ``kv`` (resident KV mirror,
        high priority) and ``prefetch`` (opportunistic staging, lowest) —
        and reserves every host-bound block against its lease before the
        transfer is submitted; a refusal defers the transfer and the
        recorded pressure drives the engine's own LRU spills. A nonzero
        ``host_kv_bytes`` becomes the kv lease's floor."""
        if model.cfg.family not in ("dense", "moe"):
            raise ValueError("serving engine requires a KV-cache family "
                             f"(dense/moe), got {model.cfg.family!r}")
        if cfg.max_len % cfg.block_size:
            raise ValueError("max_len must be a multiple of block_size")
        if pool is not None and getattr(host, "lease", None) is not None:
            raise ValueError("shared store already lease-attached: pool "
                             "arbitration would double-count its bytes")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.name = name
        self.device = model.device
        self._cuda = self.device.type == "cuda"
        self._pool = pool
        if host is not None:
            self.host = host
            self._owns_host = False
        elif pool is not None:
            # pooled: budget enforcement is reservation-driven here, so the
            # store is unbounded and spills stay engine-driven
            self.host = TieredStore({}, device=self.device, auto_spill=False)
            self._owns_host = True
        elif cfg.host_kv_bytes is not None:
            # spills are engine-driven (auto_spill off) so the disk I/O
            # lands on the disk stream's timeline, not inside put_offload
            self.host = TieredStore({}, device=self.device,
                                    host_capacity=cfg.host_kv_bytes,
                                    auto_spill=False)
            self._owns_host = True
        else:
            self.host = HostStore({}, device=self.device)
            self._owns_host = True
        self._tiered = isinstance(self.host, TieredStore)
        # per-key reservation ledger: key -> (lease, charged bytes)
        self._charged: dict[tuple[int, int], tuple] = {}
        # revocation pressure signal: a leaf lock, never the engine lock
        self._revoke_lock = lockcheck.make_lock("ServeEngine.revoke")
        self._revoked_pending = 0
        if pool is not None:
            self._kv_lease = pool.lease(
                "kv", min_bytes=cfg.host_kv_bytes or 0, weight=2.0,
                priority=2, on_revoke=self._on_revoke, drains_via=())
            self._pf_lease = pool.lease(
                "prefetch", weight=1.0, priority=0,
                on_revoke=self._on_revoke, drains_via=())
            # statically certify the pool configuration live (DESIGN.md
            # §14): when it holds, the no-progress detector below is
            # unreachable, so its firing is escalated to unsoundness
            self._liveness_certificate: LivenessCertificate | None = \
                certify_progress(MemGraph(), self.pool_model())
            self._certified_live = self._liveness_certificate.ok
        else:
            self._kv_lease = self._pf_lease = None
            self._liveness_certificate = None
            self._certified_live = False
        self.reqs: dict[int, Request] = {}
        self._live: set[int] = set()                # rids not yet DONE
        self.stats = ServeStats()
        self.kv: PagedKVCache | None = None
        self._next_rid = 0
        self._queue: list[int] = []                 # QUEUED rids, FIFO
        self._swapped: list[int] = []               # SWAPPED rids, FIFO
        self._slots: list[int | None] = []
        self._events: list[tuple] = []              # completions to apply
        self._block_seq: dict[tuple[int, int], int] = {}
        self._seq_counter = 0
        self._seed = cfg.seed
        self._lock = lockcheck.make_lock("ServeEngine")
        self._wake = threading.Condition(self._lock)
        self._d2h: _DmaStream | None = None
        self._h2d: _DmaStream | None = None
        self._disk: _DmaStream | None = None
        self._spill_inflight: set[tuple[int, int]] = set()
        self._prefetch_inflight: set[tuple[int, int]] = set()
        self._idle_spins = 0            # consecutive no-progress stalls
        self._idle_pool_state = None    # last observed (pool used, grant)
        # observation seam: on_emit(req, row_logits) is called, engine lock
        # held, with every row of logits a token is sampled from
        self.on_emit = None
        # ---- fleet / fault seams (serve/router.py) ----------------------
        # on_step(engine): called once per run-loop iteration OFF the
        # engine lock (the router beats the replica's heartbeat)
        self.on_step = None
        # hard_kill() (any thread) or fault_after_steps (raise once this
        # many decode steps have run) raise ReplicaKilled out of run();
        # its finally still joins every DMA thread
        self._killed = False
        self.fault_after_steps: int | None = None
        # pause() blocks the run loop (and its heartbeats) until resume()
        self._pause_evt = threading.Event()
        self._pause_evt.set()

    # ---------------------------------------------- pool lease bookkeeping
    def pool_model(self) -> PoolConfig:
        """The engine's pool population as the static liveness model sees
        it (DESIGN.md §14)."""
        specs = tuple(LeaseSpec(
            name=l.name, min_bytes=l.min_bytes, weight=l.weight,
            priority=l.priority, discipline="reserving",
            drains_via=tuple(getattr(l, "drains_via", ())))
            for l in self._pool.leases())
        return PoolConfig(capacity=self._pool.capacity, leases=specs,
                          policy=getattr(self._pool.policy, "name",
                                         "static"))

    def _waits_for_locked(self) -> dict:
        """The live waits-for graph, dumped when the no-progress detector
        fires."""
        if self._pool is not None:
            leases = {
                l.name: {"grant": l.grant, "used": l.used,
                         "pressure": l.pressure, "overage": l.overage,
                         "refusals": l.refusals}
                for l in self._pool.leases()}
            pool = {"capacity": self._pool.capacity,
                    "used_bytes": self._pool.used_bytes}
        else:
            leases = {}
            pool = None
        with self._revoke_lock:
            revoked = self._revoked_pending
        return {
            "replica": self.name,
            "pool": pool,
            "leases": leases,
            "revoked_pending": revoked,
            "queued": list(self._queue),
            "swapped": list(self._swapped),
            "spill_inflight": sorted(self._spill_inflight),
            "prefetch_inflight": sorted(self._prefetch_inflight),
            "inflight": {r: sorted(self.reqs[r].inflight)
                         for r in self._live if self.reqs[r].inflight},
            "states": {r: self.reqs[r].state for r in self._live},
        }

    def _on_revoke(self, deficit: int) -> None:
        """Pool callback: record the pressure only (it can fire on any
        thread, including one inside the engine lock); the next spill pass
        drains it through the disk stream."""
        with self._revoke_lock:
            self._revoked_pending += deficit

    def _charge_key_locked(self, key, lease, *, urgent: bool = True) -> bool:
        """Reserve one block's bytes on ``lease`` before submitting its
        host-bound transfer. False defers the transfer."""
        if self._pool is None:
            return True
        if key in self._charged:
            return True
        n = self.kv.block_nbytes
        if not lease.try_charge(n, urgent=urgent):
            self.stats.lease_deferrals += 1
            return False
        self._charged[key] = (lease, n)
        return True

    def _release_key_locked(self, key) -> None:
        if self._pool is None:
            return
        entry = self._charged.pop(key, None)
        if entry is not None:
            entry[0].release(entry[1])

    def _transfer_key_locked(self, key, dst) -> None:
        """Move a charged key's reservation to ``dst`` (prefetch→kv when a
        staged block's request is admitted)."""
        entry = self._charged.get(key)
        if entry is None or entry[0] is dst:
            return
        self._pool.transfer(entry[0], dst, entry[1])
        self._charged[key] = (dst, entry[1])

    # ------------------------------------------------------------- public
    def submit(self, prompt, max_new: int = 32, *,
               rid: int | None = None) -> int:
        """Enqueue a request; returns its id. Tokens emitted will be
        ``min(max_new, max_len - len(prompt) + 1)``: the first token
        samples from the prefill logits. ``rid`` pins the id (a router
        allocates ids fleet-wide: sampling folds the rid)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1 (the first token always "
                             "samples from the prefill logits)")
        if len(prompt) > self.cfg.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"max_len={self.cfg.max_len}")
        with self._lock:        # online use submits while run() is draining
            if rid is None:
                rid = self._next_rid
            elif rid in self.reqs:
                raise ValueError(f"rid {rid} already present on replica "
                                 f"{self.name!r}")
            self._next_rid = max(self._next_rid, rid + 1)
            self.reqs[rid] = Request(rid, prompt, max_new,
                                     t_submit=time.monotonic())
            self._live.add(rid)
            self._queue.append(rid)
            self._wake.notify_all()
        return rid

    def hard_kill(self) -> None:
        """Kill the replica from any thread: the run loop raises
        :class:`ReplicaKilled` at its next iteration. Device state is
        considered lost; the host/disk tiers stay for :meth:`drain_tickets`."""
        with self._lock:
            self._killed = True
            self._wake.notify_all()

    def pause(self) -> None:
        """Block the run loop (and its heartbeats) without killing it: the
        silent-wedge failure a supervisor must tell from a crash."""
        self._pause_evt.clear()

    def resume(self) -> None:
        self._pause_evt.set()

    def close(self) -> None:
        """Release the engine-owned store's backing resources (the disk
        tier's temp directory), the pool leases and the device KV cache.
        Idempotent; call it once the run loop has returned."""
        if self._owns_host:
            self.host.close()
        if self._pool is not None:
            self._kv_lease.close()
            self._pf_lease.close()
            self._charged.clear()
        with self._lock:
            # device tensors: the cache and, after a kill, reloads that
            # were never applied
            self.kv = None
            self._events.clear()
            for req in self.reqs.values():
                req.reload_data.clear()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def release(self, rid: int) -> None:
        """Drop a finished request's record."""
        with self._lock:
            req = self.reqs.get(rid)
            if req is not None and req.state != DONE:
                raise ValueError(f"request {rid} is {req.state}, not done")
            self.reqs.pop(rid, None)

    # ------------------------------------- KV migration (DESIGN.md §16)
    def _warm_payload_locked(self, req: Request) -> "list[dict] | None":
        """A SWAPPED request's complete block set from the host/disk tiers
        (``peek_offload``: no traffic counted). ``None`` unless every block
        is present and quiescent: a warm ticket is all blocks or none. A
        host block is a pinned copy the d2h stream finished before it
        handed it to the store."""
        if req.state != SWAPPED or req.inflight or req.pending_reload:
            return None
        blocks = []
        for blk in range(self.kv.n_token_blocks(req.pos)):
            data = self.host.peek_offload((req.rid, blk))
            if data is None:
                return None
            blocks.append(dict(data))
        return blocks

    def _ticket_locked(self, req: Request,
                       blocks: "list[dict] | None") -> MigrationTicket:
        return MigrationTicket(
            rid=req.rid, prompt=list(req.prompt), out=list(req.out),
            max_new=req.max_new, pos=req.pos, last=req.last,
            block_size=self.cfg.block_size,
            t_submit=req.t_submit, t_first=req.t_first, blocks=blocks)

    def drain_tickets(self) -> list[MigrationTicket]:
        """Checkpoint every live request at its last emitted token, after
        a kill. SWAPPED requests whose full block set survives on the
        host/disk tiers become *warm* tickets; the rest lost their device
        state and go *cold*. Read-only: the caller retires the engine with
        ``close()``."""
        tickets = []
        with self._lock:
            for rid in sorted(self._live):
                req = self.reqs[rid]
                blocks = (self._warm_payload_locked(req)
                          if self.kv is not None else None)
                tickets.append(self._ticket_locked(req, blocks))
        return tickets

    def export_one_swapped(self) -> MigrationTicket | None:
        """Live rebalance: detach the *tail* of the swapped FIFO as a warm
        ticket, releasing its local bytes, lease charges and seq entries.
        ``None`` when no swapped request has a complete, quiescent block
        set (an in-flight spill or prefetch defers the export)."""
        with self._lock:
            if self.kv is None:
                return None
            for i in range(len(self._swapped) - 1, -1, -1):
                rid = self._swapped[i]
                req = self.reqs[rid]
                keys = [(rid, b)
                        for b in range(self.kv.n_token_blocks(req.pos))]
                if any(k in self._spill_inflight
                       or k in self._prefetch_inflight for k in keys):
                    continue
                blocks = self._warm_payload_locked(req)
                if blocks is None:
                    continue
                ticket = self._ticket_locked(req, blocks)
                self._swapped.pop(i)
                self._live.discard(rid)
                self.reqs.pop(rid)
                for k in keys:
                    self.host.pop_offload(k)
                    self._release_key_locked(k)
                    self._block_seq.pop(k, None)
                self.stats.migrations_out += 1
                self._wake.notify_all()   # run() re-checks its live set
                return ticket
        return None

    def load(self) -> tuple[int, int]:
        """Placement signals for a router: (live request count, resident +
        committed KV tokens)."""
        with self._lock:
            return (len(self._live),
                    sum(max(self.reqs[r].pos, len(self.reqs[r].prompt))
                        for r in self._live))

    def import_migration(self, ticket: MigrationTicket) -> None:
        """Admit a warm ticket in SWAPPED state: validate every payload
        against this replica's :meth:`PagedKVCache.leaf_spec`, reserve the
        whole block set against the kv lease, then land the bytes in the
        host tier (pinned on CUDA), **all or nothing**: a
        :class:`MigrationRefused` leaves no byte, charge or record behind.
        The request resumes through the ordinary h2d reload path."""
        if ticket.blocks is None:
            raise MigrationRefused(
                f"ticket {ticket.rid} is cold (no KV payload): resubmit "
                "prompt+out for re-prefill instead")
        if ticket.block_size != self.cfg.block_size:
            raise MigrationRefused(
                f"block_size mismatch: ticket has {ticket.block_size}, "
                f"replica {self.name!r} serves {self.cfg.block_size}")
        with self._lock:
            if ticket.rid in self.reqs:
                raise MigrationRefused(
                    f"rid {ticket.rid} already present on replica "
                    f"{self.name!r}")
            if self.kv is None:
                # geometry (block bytes, leaf spec) before any validation
                bucket = self._bucket_for(1)
                self.kv = PagedKVCache(self.model, bucket, self.cfg.max_len,
                                       block_size=self.cfg.block_size)
                self._slots = [None] * bucket
                if self.kv.device.type == "cuda":
                    # zeroed on the importing thread's stream; the run
                    # loop writes the cache on its own
                    torch.cuda.current_stream(self.kv.device).synchronize()
            n_blocks = self.kv.n_token_blocks(ticket.pos)
            if len(ticket.blocks) != n_blocks:
                raise MigrationRefused(
                    f"ticket {ticket.rid} carries {len(ticket.blocks)} "
                    f"blocks for pos={ticket.pos} (want {n_blocks})")
            spec = self.kv.leaf_spec()
            for blk, data in enumerate(ticket.blocks):
                if set(data) != set(spec):
                    raise MigrationRefused(
                        f"ticket {ticket.rid} block {blk}: leaves "
                        f"{sorted(data)} != spec {sorted(spec)}")
                for leaf, (shape, dtype) in spec.items():
                    arr = data[leaf]
                    if (tuple(arr.shape) != shape
                            or dtype_name(arr.dtype) != dtype):
                        raise MigrationRefused(
                            f"ticket {ticket.rid} block {blk} leaf "
                            f"{leaf!r}: {tuple(arr.shape)}/"
                            f"{dtype_name(arr.dtype)} != {shape}/{dtype}")
            charged_now = []
            for blk in range(n_blocks):
                if self._charge_key_locked((ticket.rid, blk),
                                           self._kv_lease):
                    charged_now.append((ticket.rid, blk))
                else:
                    for key in charged_now:
                        self._release_key_locked(key)
                    raise MigrationRefused(
                        f"replica {self.name!r} cannot reserve "
                        f"{n_blocks} blocks for ticket {ticket.rid}: "
                        "kv lease refused the set")
            req = Request(ticket.rid, list(ticket.prompt), ticket.max_new,
                          out=list(ticket.out), state=SWAPPED,
                          pos=ticket.pos, last=ticket.last,
                          mirrored=set(range(n_blocks)),
                          t_submit=ticket.t_submit, t_first=ticket.t_first)
            for blk, data in enumerate(ticket.blocks):
                key = (ticket.rid, blk)
                self.host.put_offload(key, data)
                self._block_seq[key] = self._seq_counter
                self._seq_counter += 1
            self.reqs[ticket.rid] = req
            self._live.add(ticket.rid)
            self._swapped.append(ticket.rid)
            self._next_rid = max(self._next_rid, ticket.rid + 1)
            self.stats.migrations_in += 1
            self._wake.notify_all()

    def generate(self, prompts: list[list[int]], *, max_new: int = 32,
                 seed: int | None = None) -> list[list[int]]:
        """Submit ``prompts`` and run the queue to completion."""
        rids = [self.submit(p, max_new) for p in prompts]
        self.run(seed=seed)
        return [list(self.reqs[r].out) for r in rids]

    def _stream(self, kind: str, bw: float, service, pol) -> _DmaStream:
        cuda = (torch.cuda.Stream(self.device)
                if self._cuda and kind in (D2H, H2D) else None)
        return _DmaStream(kind, bw, self.cfg.dma_latency, pol, service,
                          self._lock, cuda_stream=cuda,
                          simulate=not self._cuda)

    def run(self, *, seed: int | None = None) -> ServeStats:
        """Drain the queue: admit → prefill → decode, with offload and
        reload riding on the DMA streams, until every submitted request is
        DONE. A DMA thread's error is raised here."""
        if seed is not None:
            self._seed = seed
        cfg = self.cfg
        pol = get_reload_policy(cfg.reload_policy, seed=self._seed)
        pol.prepare(self)
        self._d2h = self._stream(D2H, cfg.d2h_bw, self._service_d2h, pol)
        self._h2d = self._stream(H2D, cfg.h2d_bw, self._service_h2d, pol)
        streams = [self._d2h, self._h2d]
        if self._tiered:
            self._disk = self._stream(DISK, cfg.disk_bw, self._service_disk,
                                      pol)
            streams.append(self._disk)
        for stream in streams:
            stream.start()
        try:
            while True:
                if self.on_step is not None:
                    # off the lock: the heartbeat table is a leaf lock
                    self.on_step(self)
                self._pause_evt.wait()
                with self._lock:
                    if self._killed or (
                            self.fault_after_steps is not None
                            and self.stats.decode_steps
                            >= self.fault_after_steps):
                        raise ReplicaKilled(
                            f"replica {self.name!r} hard-killed after "
                            f"{self.stats.decode_steps} decode steps")
                    for stream in streams:
                        if stream.error is not None:
                            raise stream.error
                    self._apply_events_locked()
                    admits = self._plan_admissions_locked()
                if admits:
                    self._prefill_admit(admits)
                with self._lock:
                    self._schedule_offload_locked()
                    self._schedule_spill_locked()
                    self._schedule_prefetch_locked()
                    self._schedule_preempt_locked()
                    active = [(s, r) for s, r in enumerate(self._slots)
                              if r is not None
                              and self.reqs[r].state == RUNNING]
                    if not self._live:     # atomic with submit()'s mutation
                        break
                if active:
                    self._decode_once(active)
                else:
                    self._stall_wait()
        finally:
            with self._lock:
                for stream in streams:
                    stream.shutdown()
                self._spill_inflight.clear()
                self._prefetch_inflight.clear()
            for stream in streams:
                stream.join()
            with self._lock:
                # a transfer abandoned in a queue by the shutdown (the
                # mirror of a block whose request finished first) would
                # leave its pool reservation behind
                for key in [k for k in self._charged
                            if k[0] not in self._live]:
                    self._release_key_locked(key)
        return self.stats

    # -------------------------------------------------- DMA service hooks
    # (run on stream threads; the main loop owns cache mutation)
    def _copy_to_host(self, src: dict[str, torch.Tensor], written):
        """Copy a block's device slices into host tensors, complete. On
        CUDA: on this thread's d2h stream, after the compute stream's
        latest write (``written``), waited for with the GIL released."""
        if not self._cuda:
            return self.host._host_copy(src)
        stream = torch.cuda.current_stream(self.device)
        if written is not None:
            stream.wait_event(written)
        data = self.host._host_copy(src)
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        return data

    def _copy_to_device(self, data: dict[str, torch.Tensor]):
        """Copy a pinned host block into fresh device tensors on this
        thread's h2d stream, complete (CUDA); the host block itself on the
        CPU (host copies are never written)."""
        if not self._cuda:
            return data
        staged = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                  for k, v in data.items()}
        for k, v in data.items():
            staged[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        done.synchronize()
        return staged

    def _service_d2h(self, tr: _Transfer) -> None:
        with self._lock:
            req = self.reqs.get(tr.rid)
            if req is None:                           # released mid-flight
                self._release_key_locked((tr.rid, tr.blk))
                self._wake.notify_all()
                return
            if req.state == DONE or req.slot < 0:
                req.inflight.discard(tr.blk)
                self._release_key_locked((tr.rid, tr.blk))
                self._wake.notify_all()
                return
            slot = req.slot
            # views of the current leaves: they keep the leaves alive if
            # grow() replaces them while the copy is in flight
            src = self.kv.read_block(slot, tr.blk)
            written = self.kv.written
        # the copy runs off the engine lock so it overlaps under decode;
        # the slot cannot be reassigned while this block is in flight
        # (swap-out completes only once `inflight` drains)
        data = self._copy_to_host(src, written)
        del src
        with self._lock:
            req.inflight.discard(tr.blk)
            if req.state != DONE and req.slot == slot:
                self.host.put_offload((tr.rid, tr.blk), data, copy=False)
                # counted here, not as a HostStore delta: a runtime sharing
                # the store must not have its traffic attributed to serving
                self.stats.offload_bytes += tr.nbytes
                req.mirrored.add(tr.blk)
                if req.state == SWAPPING and not req.inflight:
                    self._events.append(("swap-done", tr.rid))
            else:
                # payload dropped: its reservation has nothing behind it
                self._release_key_locked((tr.rid, tr.blk))
            self._wake.notify_all()

    def _service_h2d(self, tr: _Transfer) -> None:
        data = self._copy_to_device(self.host.get_offload((tr.rid, tr.blk)))
        with self._lock:
            self.stats.reload_bytes += tr.nbytes
            req = self.reqs.get(tr.rid)
            if req is not None:
                req.inflight.discard(tr.blk)
                self._events.append(("reload", tr.rid, tr.blk, data))
            self._wake.notify_all()

    def _service_disk(self, tr: _Transfer) -> None:
        """Disk-stream service: ``spill`` moves a cold host block to the
        file tier, ``load`` stages a disk block back into host RAM and
        chains the h2d hop, ``prefetch`` stages ahead of admission. Load
        I/O runs off the engine lock; a spill's write stays under it, so a
        swap-in can never claim a block mid-spill."""
        key = (tr.rid, tr.blk)
        if tr.disk_op == "prefetch":
            try:
                staged = self.host.tier_of(key) == "disk"
                if staged:
                    self.host.load(key)
            except KeyError:
                staged = False
            with self._lock:
                self._prefetch_inflight.discard(key)
                req = self.reqs.get(tr.rid)
                if staged and (req is None or req.state == DONE
                               or key not in self._block_seq):
                    # the request retired while the blob was read: undo
                    # the staging, nothing would ever release it
                    self.host.pop_offload(key)
                    staged = False
                if (self._pool is not None
                        and self._charged.get(key, (None,))[0]
                        is self._pf_lease
                        and self.host.tier_of(key) != "host"):
                    # no host bytes behind the reservation: give it back
                    self._release_key_locked(key)
                if staged:
                    self.stats.disk_load_bytes += tr.nbytes
                    self.stats.prefetch_bytes += tr.nbytes
                if req is not None and tr.blk in req.pending_reload:
                    # admitted while this prefetch was in flight: chain the
                    # h2d hop (or fall back to the two-hop load)
                    if staged or self.host.tier_of(key) == "host":
                        self._h2d.submit(_Transfer(H2D, tr.rid, tr.blk,
                                                   tr.seq, tr.nbytes))
                    else:
                        self._submit_transfer_locked(self._disk, req,
                                                     tr.blk, disk_op="load")
                self._wake.notify_all()
            return
        if tr.disk_op == "spill":
            with self._lock:
                self._spill_inflight.discard(key)
                req = self.reqs.get(tr.rid)
                ok = (req is not None and req.state != DONE
                      and tr.blk not in req.pending_reload
                      and tr.blk not in req.inflight)
                if ok:
                    if self._pool is not None:
                        # this thread drains the kv lease (assumption A2):
                        # the spill may only release
                        with self._pool.draining(self._kv_lease):
                            self.stats.disk_spill_bytes += \
                                self.host.spill(key)
                    else:
                        self.stats.disk_spill_bytes += self.host.spill(key)
                    self._release_key_locked(key)
                self._wake.notify_all()
            return
        # load: read-through staging is idempotent, so a racy spill/reload
        # interleaving can only change timing, never bytes
        self.host.load(key)
        with self._lock:
            self.stats.disk_load_bytes += tr.nbytes
            req = self.reqs.get(tr.rid)
            if req is not None and tr.blk in req.pending_reload:
                self._h2d.submit(_Transfer(H2D, tr.rid, tr.blk, tr.seq,
                                           tr.nbytes))
            elif req is not None:        # swap-in abandoned mid-flight
                req.inflight.discard(tr.blk)
            self._wake.notify_all()

    # ------------------------------------------------------ event applies
    def _apply_events_locked(self) -> None:
        for ev in self._events:
            if ev[0] == "reload":
                _, rid, blk, data = ev
                req = self.reqs.get(rid)
                if req is None or req.state != RELOADING:
                    continue
                req.reload_data[blk] = data
                req.pending_reload.discard(blk)
                if not req.pending_reload:
                    self.kv.restore_slot(
                        req.slot, [req.reload_data[b]
                                   for b in sorted(req.reload_data)])
                    req.reload_data.clear()
                    req.state = RUNNING
                    req.quantum = 0
                    # the tail block keeps growing after resume: its host
                    # copy is stale from now on and must re-offload
                    if req.pos % self.cfg.block_size:
                        tail = req.pos // self.cfg.block_size
                        req.mirrored.discard(tail)
                        self.host.pop_offload((rid, tail))
                        self._release_key_locked((rid, tail))
            elif ev[0] == "swap-done":
                req = self.reqs.get(ev[1])
                if req is None or req.state != SWAPPING:
                    continue
                self.kv.drop_slot(req.slot)
                self._slots[req.slot] = None
                req.slot = -1
                req.state = SWAPPED
                self._swapped.append(req.rid)
        self._events.clear()

    # ----------------------------------------------------- admission path
    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.batch_buckets:
            if n <= b:
                return b
        return self.cfg.batch_buckets[-1]

    def _plan_admissions_locked(self) -> list[tuple[int, int]]:
        """Assign free slots: fresh requests first (returned for batched
        prefill), then swapped requests (their reloads scheduled). Grows
        the cache to the next batch bucket when demand requires."""
        want = len(self._swapped) + len(self._queue)
        if want == 0:
            return []
        occupied = sum(r is not None for r in self._slots)
        desired = self._bucket_for(occupied + want)
        if self.kv is None:
            self.kv = PagedKVCache(
                self.model, desired, self.cfg.max_len,
                block_size=self.cfg.block_size)
            self._slots = [None] * desired
        elif desired > self.kv.bucket:
            self.kv.grow(desired)
            self._slots.extend([None] * (desired - len(self._slots)))
        free = [s for s, r in enumerate(self._slots) if r is None]

        # fresh requests admit before swapped resumes: a preemption's point
        # is to let waiters in
        admits: list[tuple[int, int]] = []
        while free and self._queue:
            rid = self._queue.pop(0)
            slot = free.pop(0)
            self._slots[slot] = rid
            self.reqs[rid].slot = slot
            admits.append((slot, rid))

        # swap-ins: host-resident blocks reload through the h2d stream;
        # disk-resident blocks take the two-hop chain; a block whose
        # prefetch is in flight is chained by the prefetch handler
        while free and self._swapped:
            rid = self._swapped[0]
            req = self.reqs[rid]
            blocks = range(self.kv.n_token_blocks(req.pos))
            if self._pool is not None:
                # reserve the resume's host-side staging before taking the
                # slot; a refusal defers the admission (FIFO preserved)
                charged_now = []
                ok = True
                for blk in blocks:
                    key = (rid, blk)
                    if (key in self._charged
                            or key in self._prefetch_inflight
                            or not self._tiered
                            or self.host.tier_of(key) != "disk"):
                        continue
                    if self._charge_key_locked(key, self._kv_lease):
                        charged_now.append(key)
                    else:
                        ok = False
                        break
                if not ok:
                    for key in charged_now:
                        self._release_key_locked(key)
                    break
                for blk in blocks:
                    self._transfer_key_locked((rid, blk), self._kv_lease)
            self._swapped.pop(0)
            slot = free.pop(0)
            self._slots[slot] = rid
            req.slot = slot
            req.state = RELOADING
            req.pending_reload = set(blocks)
            for blk in blocks:
                if (rid, blk) in self._prefetch_inflight:
                    req.inflight.add(blk)   # h2d chains on the prefetch
                elif (self._tiered
                        and self.host.tier_of((rid, blk)) == "disk"):
                    self._submit_transfer_locked(self._disk, req, blk,
                                                 disk_op="load")
                else:
                    self._submit_transfer_locked(self._h2d, req, blk)
        return admits

    def _submit_transfer_locked(self, stream: _DmaStream, req: Request,
                                blk: int, *, disk_op: str = "") -> None:
        key = (req.rid, blk)
        if key not in self._block_seq:
            self._block_seq[key] = self._seq_counter
            self._seq_counter += 1
        req.inflight.add(blk)
        stream.submit(_Transfer(stream.kind, req.rid, blk,
                                self._block_seq[key], self.kv.block_nbytes,
                                disk_op=disk_op))

    # ------------------------------------------------------------ prefill
    def _prefill_admit(self, admits: list[tuple[int, int]]) -> None:
        """One batched forward over the admitted prompts (padded to a
        (bucket, block-aligned length) shape), then scatter the K/V into the
        admitted slots and sample each request's first token."""
        cfg = self.cfg
        reqs = [self.reqs[rid] for _, rid in admits]
        max_p = max(len(r.prompt) for r in reqs)
        s_pad = min(-(-max_p // cfg.block_size) * cfg.block_size,
                    cfg.max_len)
        b_pad = self._bucket_for(len(reqs))
        toks = np.zeros((b_pad, s_pad), np.int64)
        lengths = np.ones((b_pad,), np.int64)
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
        t0 = time.perf_counter()
        logits, kv = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lengths).to(self.device))
        logits_np = _to_numpy(logits)
        self.stats.prefill_time += time.perf_counter() - t0
        self.stats.prefill_calls += 1
        with self._lock:
            self.kv.scatter_prefill([slot for slot, _ in admits],
                                    {k: v[:, :len(reqs)]
                                     for k, v in kv.items()})
            for i, (slot, rid) in enumerate(admits):
                req = self.reqs[rid]
                req.pos = len(req.prompt)
                req.state = RUNNING
                req.quantum = 0
                self.stats.prefill_tokens += req.pos
                self.stats.kv_bytes_written += int(
                    req.pos * self.kv.token_nbytes)
                self._emit_locked(req, logits_np[i])

    def _emit_locked(self, req: Request, row_logits: np.ndarray) -> None:
        if self.on_emit is not None:
            self.on_emit(req, row_logits)
        if req.t_first == 0.0:      # a migrated request keeps its stamp
            req.t_first = time.monotonic()
        tok = _sample_token(row_logits, seed=self._seed, rid=req.rid,
                            pos=req.pos, temperature=self.cfg.temperature,
                            vocab_size=self.model.cfg.vocab_size)
        req.out.append(tok)
        req.last = tok
        self.stats.tokens += 1
        if len(req.out) >= req.max_new or req.pos >= self.cfg.max_len:
            self._finish_locked(req)

    def _finish_locked(self, req: Request) -> None:
        req.state = DONE
        self._live.discard(req.rid)
        if req.slot >= 0:
            self._slots[req.slot] = None
            req.slot = -1
        for blk in req.mirrored:
            self.host.pop_offload((req.rid, blk))
            self._release_key_locked((req.rid, blk))
        req.mirrored.clear()
        req.pending_reload.clear()
        for blk in range(self.kv.n_token_blocks(req.pos)):
            self._block_seq.pop((req.rid, blk), None)
        # in-flight d2h mirrors see state == DONE and drop their payload
        # (and release their reservations)

    # ------------------------------------------------- offload scheduling
    def _schedule_offload_locked(self) -> None:
        """Mirror cold blocks of running rows to the host store (eager d2h
        that overlaps under decode; makes a later swap-out nearly free)."""
        cfg = self.cfg
        if not cfg.offload or self.kv is None:
            return
        for slot, rid in enumerate(self._slots):
            if rid is None:
                continue
            req = self.reqs[rid]
            if req.state != RUNNING:
                continue
            cold = max(req.pos - cfg.hot_window, 0) // cfg.block_size
            cap = int(cfg.offload_fraction
                      * self.kv.n_token_blocks(req.pos))
            for blk in range(min(cold, cap)):
                if blk not in req.mirrored and blk not in req.inflight:
                    # shared pool: reserve before the bytes move; a refusal
                    # defers this and every later mirror
                    if not self._charge_key_locked((rid, blk),
                                                   self._kv_lease):
                        return
                    self._submit_transfer_locked(self._d2h, req, blk)

    def _schedule_spill_locked(self) -> None:
        """Once the host KV mirror passes ``host_kv_bytes`` (or the pool
        presses), push the least-recently-used mirrored blocks down to the
        disk tier on the disk stream."""
        if not self._tiered or self._disk is None or self.kv is None:
            return
        blk_n = self.kv.block_nbytes
        if self._pool is not None:
            with self._revoke_lock:
                if self._revoked_pending:
                    self.stats.revocations += 1
                    self._revoked_pending = 0
            budget = (self._kv_lease.overage + self._kv_lease.pressure
                      + self._pf_lease.overage + self._pf_lease.pressure
                      - len(self._spill_inflight) * blk_n)
        else:
            cap = self.cfg.host_kv_bytes
            if cap is None:
                return
            budget = (self.host.resident_bytes
                      - len(self._spill_inflight) * blk_n - cap)
        if budget <= 0:
            return
        for key in self.host.lru_keys():
            if budget <= 0:
                break
            if (key not in self._block_seq or key in self._spill_inflight
                    or key in self._prefetch_inflight):
                continue                    # not a serving block / queued
            rid, blk = key
            req = self.reqs.get(rid)
            if (req is None or req.state == RELOADING
                    or blk in req.inflight or blk in req.pending_reload):
                continue
            self._spill_inflight.add(key)
            self._disk.submit(_Transfer(DISK, rid, blk,
                                        self._block_seq[key],
                                        self.kv.block_nbytes,
                                        disk_op="spill"))
            budget -= self.kv.block_nbytes

    def _schedule_prefetch_locked(self) -> None:
        """Stage the next-scheduled swapped requests' disk-resident blocks
        back into host RAM while decode runs, within the host budget's
        free headroom."""
        cfg = self.cfg
        cap = cfg.host_kv_bytes
        if (not cfg.prefetch_swapped or not self._tiered
                or self._disk is None or self.kv is None):
            return
        if self._pool is None and cap is None:
            return
        if self._pool is None:
            # reserve headroom for everything already headed host-side
            reserved = len(self._prefetch_inflight) + sum(
                len(self.reqs[r].pending_reload | self.reqs[r].inflight)
                for r in self._live)
            headroom = (cap - self.host.resident_bytes
                        - reserved * self.kv.block_nbytes)
        for rid in self._swapped:
            if self._pool is None and headroom < self.kv.block_nbytes:
                return
            req = self.reqs.get(rid)
            if req is None:
                continue
            for blk in range(self.kv.n_token_blocks(req.pos)):
                if self._pool is None and headroom < self.kv.block_nbytes:
                    return
                key = (rid, blk)
                if (key in self._prefetch_inflight
                        or key in self._spill_inflight
                        or self.host.tier_of(key) != "disk"):
                    continue
                if self._pool is not None:
                    if self._kv_lease.pressure > 0:
                        # mandatory work waits on the spill stream: staging
                        # now would only churn it
                        return
                    if not self._charge_key_locked(key, self._pf_lease,
                                                   urgent=False):
                        return
                self._prefetch_inflight.add(key)
                self._disk.submit(_Transfer(
                    DISK, rid, blk, self._block_seq.get(key, 0),
                    self.kv.block_nbytes, disk_op="prefetch"))
                if self._pool is None:
                    headroom -= self.kv.block_nbytes

    def _schedule_preempt_locked(self) -> None:
        """Swap out requests that exhausted their decode quantum while
        others wait: the continuous-batching fairness lever, and the source
        of reload traffic."""
        cfg = self.cfg
        if not cfg.preempt_every or self.kv is None:
            return
        waiting = len(self._queue) + len(self._swapped)
        for slot, rid in enumerate(self._slots):
            if waiting <= 0:
                return
            if rid is None:
                continue
            req = self.reqs[rid]
            if req.state != RUNNING or req.quantum < cfg.preempt_every:
                continue
            if len(req.out) >= req.max_new - 1:     # about to finish anyway
                continue
            pending = [blk for blk in range(self.kv.n_token_blocks(req.pos))
                       if blk not in req.mirrored and blk not in req.inflight]
            if self._pool is not None:
                # a swap-out mirrors every unmirrored block: all or nothing
                charged_now = []
                ok = True
                for blk in pending:
                    key = (rid, blk)
                    if key in self._charged:
                        continue
                    if self._charge_key_locked(key, self._kv_lease):
                        charged_now.append(key)
                    else:
                        ok = False
                        break
                if not ok:
                    for key in charged_now:
                        self._release_key_locked(key)
                    continue
            req.state = SWAPPING
            self.stats.swaps += 1
            waiting -= 1
            for blk in pending:
                self._submit_transfer_locked(self._d2h, req, blk)
            if not req.inflight:                    # everything was mirrored
                self._events.append(("swap-done", rid))

    # -------------------------------------------------------------- decode
    def _decode_once(self, active: list[tuple[int, int]]) -> None:
        with self._lock:
            self._idle_spins = 0               # decode is forward progress
            bucket = self.kv.bucket
            toks = np.zeros((bucket, 1), np.int64)
            lens = np.zeros((bucket,), np.int64)
            mask = np.zeros((bucket,), bool)
            for slot, rid in active:
                req = self.reqs[rid]
                toks[slot, 0] = req.last
                lens[slot] = req.pos
                mask[slot] = True
            cache = self.kv.cache
        # the cache is written in place, only here and by the
        # PagedKVCache methods, all on this thread
        t0 = time.perf_counter()
        logits, _ = self.model.decode_step(
            self.params, cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lens).to(self.device),
            torch.from_numpy(mask).to(self.device))
        self.kv.mark_written()
        logits_np = _to_numpy(logits)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decode_steps += 1
        with self._lock:
            for slot, rid in active:
                req = self.reqs[rid]
                req.pos += 1
                req.quantum += 1
                self.stats.kv_bytes_written += int(self.kv.token_nbytes)
                self.stats.decode_tokens += 1
                self._emit_locked(req, logits_np[slot])

    def _stall_wait(self) -> None:
        """Nothing resident to decode: wait for a DMA completion event."""
        t0 = time.perf_counter()
        with self._wake:
            busy = (self._events or self._d2h.pending or self._h2d.pending
                    or (self._disk is not None and self._disk.pending)
                    or self._spill_inflight or self._prefetch_inflight
                    or any(self.reqs[r].inflight for r in self._live))
            if not busy and not self._queue and not self._swapped:
                raise RuntimeError(
                    f"serving scheduler wedged on replica {self.name!r} — "
                    f"live waits-for graph: {self._waits_for_locked()}")
            if busy:
                self._idle_spins = 0
            elif self._pool is not None:
                # deferred admissions with nothing in flight: any movement
                # of pool occupancy or our grant is progress
                state = (self._pool.used_bytes, self._kv_lease.grant)
                if state != self._idle_pool_state:
                    self._idle_pool_state = state
                    self._idle_spins = 0
                self._idle_spins += 1
                if self._idle_spins > 100:
                    waits = self._waits_for_locked()
                    if self._certified_live:
                        raise LivenessModelError(
                            "no-progress detector fired on replica "
                            f"{self.name!r} under a liveness-certified "
                            "pool configuration (statically unreachable) — "
                            f"live waits-for graph: {waits}")
                    raise RuntimeError(
                        f"shared-pool deadlock on replica {self.name!r}: "
                        "swapped requests cannot reserve their resume "
                        "staging and no consumer is releasing any — live "
                        f"waits-for graph: {waits}")
            self._wake.wait(timeout=0.1)
        self.stats.stall_time += time.perf_counter() - t0


# --------------------------------------------------------------------------
# the unbatched oracle
# --------------------------------------------------------------------------
def naive_generate(model, params, prompt, *, max_new: int = 32,
                   max_len: int = 512, rid: int = 0, seed: int = 0,
                   temperature: float = 0.0, on_emit=None) -> list[int]:
    """Reference decode for ONE request, no batching, padding or offload:
    one prefill forward, then single-row decode steps, sampling with the
    engine's (seed, rid, position) schedule. ``Engine.generate`` must
    reproduce this for every batching and offload configuration.
    ``on_emit(pos, row_logits)`` sees every row a token is sampled from."""
    prompt = [int(t) for t in prompt]
    p_len = len(prompt)
    dev = model.device
    vocab = model.cfg.vocab_size
    logits, kv = model.prefill(params, torch.tensor([prompt], device=dev),
                               torch.tensor([p_len], device=dev))
    cache = model.init_cache(1, max_len)
    for k, leaf in cache.items():
        leaf[:, :, :p_len].copy_(kv[k])
    del kv
    out: list[int] = []
    pos = p_len
    row = _to_numpy(logits[0])
    while True:
        if on_emit is not None:
            on_emit(pos, row)
        tok = _sample_token(row, seed=seed, rid=rid, pos=pos,
                            temperature=temperature, vocab_size=vocab)
        out.append(tok)
        if len(out) >= max_new or pos >= max_len:
            return out
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[tok]], device=dev),
            torch.tensor([pos], device=dev))
        row = _to_numpy(logits[0])
        pos += 1
