"""Fleet-scale serving: a router over N engine replicas (DESIGN.md §16).

The port of ``repro/serve/router.py``. The :class:`Router` owns a shared
admission queue in front of ``topology.n_replicas`` independent
:class:`~repro_torch.serve.Engine` replicas, each with its own host/disk
tier population (and, with ``topology.host_bytes_per_replica``, its own
arbitrated :class:`~repro_torch.core.pool.HostPool`). Three mechanisms
make it a fleet:

* **Placement**: every admission picks a replica through a policy
  (:data:`PLACEMENT_POLICY_NAMES`) reading :meth:`Engine.load`. Request ids
  are allocated by the router and pinned with ``submit(rid=)``: sampling
  folds only ``(seed, rid, position)``, so a request's tokens are the same
  wherever it lands.
* **Migration**: swapped requests move between replicas as
  :class:`~repro_torch.serve.MigrationTicket` payloads serialised by
  :func:`encode_ticket` / :func:`decode_ticket` in the disk tier's framed
  record format (``DiskStore._MAGIC`` / ``_HDR``), byte for byte the
  reference's wire format, and shipped over :class:`_NicStream`. Import is
  all-or-nothing (:meth:`Engine.import_migration`); a refused ticket falls
  back to cold re-prefill of ``prompt + out``, token-exact either way.
* **Drain**: each replica's run loop beats a
  :class:`~repro_torch.ft.supervisor.Heartbeat`; a replica that crashes
  (:class:`~repro_torch.serve.ReplicaKilled`) or goes silent is drained:
  taken out of placement, hard-killed, its worker joined (its run loop
  joins its DMA threads on the way out, so no copy is in flight),
  every live request checkpointed (:meth:`Engine.drain_tickets`: swapped
  requests ship *warm* from the host tier, the rest *cold*), shipped to
  survivors and resumed token-exact.

On the card the replicas share one copy of the parameters, and each
replica's worker thread runs its engine inside a CUDA stream of its own, so
the replicas' compute streams interleave instead of serialising on the
default stream. No device tensor crosses replicas: tickets are host bytes.

Lock order (the port's lock-order sanitizer audits it): Router →
ServeEngine; Heartbeat and NicStream are leaves; no path holds two
ServeEngine locks at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import random
import threading
import time

import numpy as np
import torch

from ..core import lockcheck
from ..core.bridge import numpy_bytes, tensor_from_bytes
from ..core.pool import HostPool
from ..core.stores import DiskStore
from ..ft.supervisor import Heartbeat
from ..launch.mesh import FleetTopology
from .engine import (DONE, Engine, MigrationRefused, MigrationTicket,
                     ReplicaKilled, ServeConfig)

__all__ = ["Router", "RouterStats", "PLACEMENT_POLICY_NAMES",
           "PlacementPolicy", "get_placement",
           "encode_ticket", "decode_ticket"]


# --------------------------------------------------------------------------
# wire codec: spill.log's framed-record format
# --------------------------------------------------------------------------
# A ticket on the wire is a sequence of records, each framed like a
# DiskStore spill.log record (magic + payload length, then raw bytes):
# first a JSON header (identity, progress, per-block leaf specs), then, for
# a warm ticket, one record per (block, leaf) payload in sorted leaf order.
# Dtypes are named as numpy names them; a bfloat16 payload is its raw
# 16-bit words, so neither package needs the other's dtype library.
_MAGIC = DiskStore._MAGIC
_HDR = DiskStore._HDR


def _frame(payload: bytes) -> bytes:
    return _HDR.pack(_MAGIC, len(payload)) + payload


def _unframe(data: bytes, off: int) -> tuple[bytes, int]:
    hdr = data[off:off + _HDR.size]
    if len(hdr) != _HDR.size:
        raise ValueError("torn migration record header")
    magic, n = _HDR.unpack(hdr)
    if magic != _MAGIC:
        raise ValueError(f"bad migration record magic {magic!r}")
    off += _HDR.size
    payload = data[off:off + n]
    if len(payload) != n:
        raise ValueError(f"torn migration record payload: "
                         f"{len(payload)}/{n} bytes")
    return payload, off + n


def encode_ticket(t: MigrationTicket) -> bytes:
    """Serialise a ticket to one self-describing blob, bit-exact."""
    blocks = t.blocks if t.blocks is not None else []
    arrs = [[(k, *numpy_bytes(b[k])) for k in sorted(b)] for b in blocks]
    head = {
        "rid": t.rid, "prompt": list(map(int, t.prompt)),
        "out": list(map(int, t.out)), "max_new": t.max_new,
        "pos": t.pos, "last": t.last, "block_size": t.block_size,
        "t_submit": t.t_submit, "t_first": t.t_first,
        "warm": t.blocks is not None,
        "blocks": [[[k, list(a.shape), name] for k, name, a in blk]
                   for blk in arrs],
    }
    parts = [_frame(json.dumps(head).encode())]
    for blk in arrs:
        for _, _, a in blk:
            parts.append(_frame(a.tobytes()))
    return b"".join(parts)


def decode_ticket(data: bytes) -> MigrationTicket:
    """Inverse of :func:`encode_ticket` (CPU tensors); validates every
    frame and refuses trailing bytes, so a truncated or corrupted ship
    fails loudly instead of landing garbage KV."""
    head_b, off = _unframe(data, 0)
    head = json.loads(head_b.decode())
    blocks = None
    if head["warm"]:
        blocks = []
        for specs in head["blocks"]:
            blk = {}
            for name, shape, dtype in specs:
                payload, off = _unframe(data, off)
                blk[name] = tensor_from_bytes(payload, dtype, tuple(shape))
            blocks.append(blk)
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing bytes after ticket")
    return MigrationTicket(
        rid=head["rid"], prompt=list(head["prompt"]), out=list(head["out"]),
        max_new=head["max_new"], pos=head["pos"], last=head["last"],
        block_size=head["block_size"], t_submit=head["t_submit"],
        t_first=head["t_first"], blocks=blocks)


# --------------------------------------------------------------------------
# placement policies
# --------------------------------------------------------------------------
PLACEMENT_POLICY_NAMES = ("least-loaded", "join-shortest-kv", "random")


class PlacementPolicy:
    """Pick a replica for an admission (or a migration target) from the
    alive set. Policies change *where* a request runs, never *what* it
    emits."""

    name = "base"

    def pick(self, replicas: "list[_Replica]") -> "_Replica":
        raise NotImplementedError


class LeastLoadedPlacement(PlacementPolicy):
    """Fewest live requests wins; ties break on replica index."""

    name = "least-loaded"

    def pick(self, replicas):
        return min(replicas, key=lambda r: (r.engine.load()[0], r.index))


class JoinShortestKVPlacement(PlacementPolicy):
    """Fewest resident+committed KV tokens wins; ties break on index."""

    name = "join-shortest-kv"

    def pick(self, replicas):
        return min(replicas, key=lambda r: (r.engine.load()[1], r.index))


class RandomPlacement(PlacementPolicy):
    """Seeded uniform choice: the chaos harness's adversarial baseline."""

    name = "random"

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)

    def pick(self, replicas):
        return self._rng.choice(replicas)


def get_placement(policy: str | PlacementPolicy | None, *,
                  seed: int = 0) -> PlacementPolicy:
    if isinstance(policy, PlacementPolicy):
        return policy
    if policy is None or policy == "least-loaded":
        return LeastLoadedPlacement()
    if policy == "join-shortest-kv":
        return JoinShortestKVPlacement()
    if policy == "random":
        return RandomPlacement(seed)
    raise ValueError(f"unknown placement policy {policy!r} "
                     f"(have {PLACEMENT_POLICY_NAMES})")


# --------------------------------------------------------------------------
# the inter-replica transfer stream
# --------------------------------------------------------------------------
class _NicStream(threading.Thread):
    """The inter-replica link: one thread serving framed ticket blobs FIFO.
    It models a network link between hosts, not a device: it sleeps the
    priced wire time (``latency + nbytes / bw``, the simulator's NIC
    channel) before it calls the delivery callback, on the CPU and on the
    card alike (one box has no such link to use). Deliveries run on this
    thread with no router lock held."""

    def __init__(self, bw: float, latency: float) -> None:
        super().__init__(name="nic", daemon=True)
        self.bw = bw
        self.latency = latency
        self._cond = threading.Condition(lockcheck.make_lock("NicStream"))
        self._queue: collections.deque = collections.deque()
        self._shutdown = False
        self.shipped_bytes = 0
        self.transfers = 0

    def send(self, data: bytes, deliver) -> tuple[threading.Event, dict]:
        """Enqueue one blob; returns ``(done, box)``: ``done`` is set after
        delivery, ``box['error']`` carries a delivery exception."""
        done = threading.Event()
        box: dict = {}
        with self._cond:
            if self._shutdown:
                raise RuntimeError("nic stream is shut down")
            self._queue.append((data, deliver, done, box))
            self._cond.notify_all()
        return done, box

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._shutdown:
                    self._cond.wait()
                if not self._queue:
                    return
                data, deliver, done, box = self._queue.popleft()
            time.sleep(self.latency + len(data) / self.bw)
            try:
                deliver(data)
            except BaseException as e:   # noqa: BLE001 — surfaced via box
                box["error"] = e
            finally:
                with self._cond:
                    self.shipped_bytes += len(data)
                    self.transfers += 1
                done.set()


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Replica:
    index: int
    name: str
    engine: Engine
    pool: HostPool | None
    thread: threading.Thread | None = None
    alive: bool = True
    fault: BaseException | None = None
    closed: bool = False


@dataclasses.dataclass
class RouterStats:
    submitted: int = 0
    completed: int = 0
    migrations: int = 0          # warm tickets delivered (drain + rebalance)
    migrated_bytes: int = 0      # wire bytes of delivered warm tickets
    reprefills: int = 0          # cold fallbacks (device state lost)
    replicas_killed: int = 0
    drain_time: float = 0.0      # wall seconds spent draining dead replicas
    ttft_p99: dict[str, float] = dataclasses.field(default_factory=dict)


class Router:
    """N serving replicas behind one admission queue::

        with Router(model, params, cfg, topology=topo) as router:
            rids = [router.submit(p, max_new=32) for p in prompts]
            router.wait(rids, timeout=600)
            outs = [router.result(r) for r in rids]

    Replica worker threads start at construction and idle between bursts;
    :meth:`close` (or the context exit) joins every thread the router
    started. Every replica serves the one ``params``."""

    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(), *,
                 topology: FleetTopology | None = None,
                 placement: str | PlacementPolicy = "least-loaded",
                 seed: int | None = None) -> None:
        self.topology = topology if topology is not None else FleetTopology()
        self.cfg = cfg
        if seed is None:
            seed = cfg.seed
        self.placement = get_placement(placement, seed=seed)
        self._lock = lockcheck.make_lock("Router")
        self._cond = threading.Condition(self._lock)
        self.heartbeat = Heartbeat(
            timeout_s=self.topology.heartbeat_timeout_s)
        self.nic = _NicStream(self.topology.nic_bw, self.topology.nic_latency)
        self.stats = RouterStats()
        self._records: dict[int, dict] = {}
        self._admit: collections.deque = collections.deque()
        self._next_rid = 0
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self.replicas: list[_Replica] = []
        for i, name in enumerate(self.topology.replica_names):
            pool = (HostPool(self.topology.host_bytes_per_replica)
                    if self.topology.host_bytes_per_replica else None)
            eng = Engine(model, params, cfg, pool=pool, name=name)
            # each run-loop iteration beats the heartbeat OFF the engine
            # lock; a wedged or paused loop stops beating and is drained
            eng.on_step = (lambda _eng, _name=name:
                           self.heartbeat.beat(_name))
            self.replicas.append(_Replica(i, name, eng, pool))
        self.nic.start()
        for rep in self.replicas:
            rep.thread = threading.Thread(
                target=self._worker, args=(rep,),
                name=f"router-{rep.name}", daemon=True)
            rep.thread.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="router-monitor", daemon=True)
        self._monitor.start()

    # --------------------------------------------------------- admission
    def submit(self, prompt, max_new: int = 32) -> int:
        """Enqueue a request on the shared admission queue; returns its
        fleet-wide rid."""
        prompt = [int(t) for t in prompt]
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._records[rid] = {
                "prompt": prompt, "max_new": max_new, "prefix": [],
                "replica": None, "done": False,
                "t_submit": time.monotonic(), "t_first": 0.0}
            self._admit.append(rid)
            self.stats.submitted += 1
            self._dispatch_locked()
        return rid

    def _dispatch_locked(self) -> None:
        """Drain the admission queue onto alive replicas. With every
        replica down the queue holds: requests are never dropped."""
        while self._admit:
            alive = [r for r in self.replicas if r.alive]
            if not alive:
                return
            rid = self._admit.popleft()
            rec = self._records[rid]
            rep = self.placement.pick(alive)
            rep.engine.submit(rec["prompt"], rec["max_new"], rid=rid)
            rec["replica"] = rep

    # --------------------------------------------------------- results
    def result(self, rid: int) -> list[int]:
        """Tokens emitted so far: the router-held prefix (tokens emitted
        before a cold migration) plus the hosting replica's live tail."""
        with self._lock:
            rec = self._records[rid]
            prefix = list(rec["prefix"])
            rep = rec["replica"]
        if rep is None:
            return prefix
        with rep.engine._lock:
            req = rep.engine.reqs.get(rid)
            tail = list(req.out) if req is not None else []
        return prefix + tail

    def done(self, rid: int) -> bool:
        with self._lock:
            rec = self._records[rid]
            if rec["done"]:
                return True
            rep = rec["replica"]
        if rep is None:
            return False
        with rep.engine._lock:
            req = rep.engine.reqs.get(rid)
            finished = req is not None and req.state == DONE
        if finished:
            with self._lock:
                if not rec["done"]:
                    rec["done"] = True
                    self.stats.completed += 1
        return finished

    def wait(self, rids: "list[int] | None" = None,
             timeout: float | None = None) -> None:
        """Block until every request in ``rids`` (default: all submitted)
        completes. Re-raises a router-level fault (a non-kill replica
        crash, a failed drain) rather than hanging on it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._error is not None:
                    raise self._error
                pending = list(self._records if rids is None else rids)
            if all(self.done(r) for r in pending):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"requests still pending after {timeout}s: "
                    f"{[r for r in pending if not self.done(r)]}")
            time.sleep(0.005)

    # --------------------------------------------------------- fleet loops
    def _worker(self, rep: _Replica) -> None:
        """One replica's loop: run the engine whenever it has live work,
        beat the heartbeat while idle, inside the replica's own CUDA
        stream on the card. A :class:`ReplicaKilled` marks the replica
        faulted for the monitor to drain."""
        eng = rep.engine
        ctx = (torch.cuda.stream(torch.cuda.Stream(eng.device))
               if eng.device.type == "cuda" else contextlib.nullcontext())
        try:
            with ctx:
                while not self._stop.is_set():
                    with eng._lock:
                        busy = bool(eng._live)
                        killed = eng._killed
                    if killed:
                        # a kill can land while the replica is idle; run()
                        # would never observe it
                        return
                    if not busy:
                        self.heartbeat.beat(rep.name)
                        time.sleep(0.005)
                        continue
                    eng.run()
        except ReplicaKilled as e:
            if not self._stop.is_set():
                with self._cond:
                    rep.fault = e
                    self._cond.notify_all()
        except BaseException as e:   # noqa: BLE001 — surfaced via wait()
            with self._cond:
                rep.fault = e
                self._error = e
                self._cond.notify_all()

    def _monitor_loop(self) -> None:
        """Drain replicas that crashed (worker fault) or went silent
        (missed heartbeats), and keep the admission queue moving."""
        while not self._stop.is_set():
            with self._cond:
                self._cond.wait(timeout=0.02)
                if self._stop.is_set():
                    return
                dead = set(self.heartbeat.dead_workers())
                faulted = [r for r in self.replicas if r.alive
                           and (r.fault is not None or r.name in dead)]
            for rep in faulted:
                try:
                    self._drain_replica(rep)
                except BaseException as e:   # noqa: BLE001
                    with self._lock:
                        self._error = e
                    return
            with self._lock:
                self._dispatch_locked()

    def _drain_replica(self, rep: _Replica) -> None:
        """Remove from placement → hard-kill → resume (a paused loop must
        wake to see the kill) → join the worker (its ``run()`` joins every
        DMA thread) → forget the heartbeat → checkpoint every live request
        → ship each (warm import, cold re-prefill fallback) → close the
        engine (its store and its device cache)."""
        t0 = time.monotonic()
        with self._lock:
            if not rep.alive:
                return
            rep.alive = False
        rep.engine.hard_kill()
        rep.engine.resume()
        if rep.thread is not None:
            rep.thread.join()
        self.heartbeat.forget(rep.name)
        tickets = rep.engine.drain_tickets()
        for ticket in tickets:
            self._ship(ticket)
        rep.engine.close()
        rep.closed = True
        with self._lock:
            self.stats.replicas_killed += 1
            self.stats.drain_time += time.monotonic() - t0

    def _ship(self, ticket: MigrationTicket) -> None:
        """Serialise one ticket, pick a surviving target, push it through
        the transfer stream, and wait for delivery."""
        data = encode_ticket(ticket)
        with self._lock:
            alive = [r for r in self.replicas if r.alive]
        if not alive:
            raise RuntimeError(
                f"request {ticket.rid}: no surviving replica to drain to")
        target = self.placement.pick(alive)
        done, box = self.nic.send(
            data, lambda blob, _t=target: self._deliver(blob, _t))
        done.wait()
        if "error" in box:
            raise box["error"]

    def _deliver(self, data: bytes, target: _Replica) -> None:
        """NIC-thread delivery: decode, try the warm all-or-nothing import,
        fall back to cold re-prefill. Router state is updated after the
        engine call, never while holding both locks."""
        ticket = decode_ticket(data)
        if ticket.warm:
            try:
                target.engine.import_migration(ticket)
                with self._lock:
                    rec = self._records.get(ticket.rid)
                    if rec is not None:
                        rec["replica"] = target
                        if ticket.t_first and not rec["t_first"]:
                            rec["t_first"] = ticket.t_first
                    self.stats.migrations += 1
                    self.stats.migrated_bytes += len(data)
                return
            except MigrationRefused:
                pass   # the destination kept its invariants; go cold
        self._cold_resume(ticket, target)

    def _cold_resume(self, ticket: MigrationTicket,
                     target: _Replica) -> None:
        """Re-prefill ``prompt + out`` on the target. Token-exact: the next
        sample folds (seed, rid, len(prompt + out)), and the tokens emitted
        so far move into the router-held prefix."""
        remaining = ticket.max_new - len(ticket.out)
        with self._lock:
            rec = self._records.get(ticket.rid)
            if rec is not None:
                rec["prefix"].extend(ticket.out)
                rec["replica"] = target
                if ticket.t_first and not rec["t_first"]:
                    rec["t_first"] = ticket.t_first
                if remaining < 1:
                    rec["done"] = True
                    self.stats.completed += 1
                    return
            elif remaining < 1:
                return
            self.stats.reprefills += 1
        target.engine.submit(ticket.prompt + ticket.out, remaining,
                             rid=ticket.rid)

    # --------------------------------------------------------- rebalance
    def rebalance_once(self) -> bool:
        """Live migration (no fault): detach the most-loaded alive
        replica's longest-waiting swapped request and ship it to a
        placement-picked peer. Returns True if a ticket moved."""
        with self._lock:
            alive = [r for r in self.replicas if r.alive]
        if len(alive) < 2:
            return False
        src = max(alive, key=lambda r: (r.engine.load()[0], -r.index))
        ticket = src.engine.export_one_swapped()
        if ticket is None:
            return False
        data = encode_ticket(ticket)
        target = self.placement.pick([r for r in alive if r is not src])
        done, box = self.nic.send(
            data, lambda blob, _t=target: self._deliver(blob, _t))
        done.wait()
        if "error" in box:
            raise box["error"]
        return True

    # --------------------------------------------------------- kill seam
    def kill_replica(self, name: str) -> None:
        """Chaos seam: hard-kill one replica by name (the monitor drains
        it). No-op if it is already dead."""
        for rep in self.replicas:
            if rep.name == name:
                rep.engine.hard_kill()
                return
        raise KeyError(f"no replica named {name!r}")

    # --------------------------------------------------------- accounting
    def ttft_samples(self) -> dict[str, list[float]]:
        """Per-replica time-to-first-token samples (seconds), attributed to
        the replica that finally hosts each request."""
        out: dict[str, list[float]] = {}
        with self._lock:
            recs = [(rid, dict(rec)) for rid, rec in self._records.items()]
        for rid, rec in recs:
            rep = rec["replica"]
            if rep is None:
                continue
            t_first = rec["t_first"]
            if not t_first:
                with rep.engine._lock:
                    req = rep.engine.reqs.get(rid)
                    t_first = req.t_first if req is not None else 0.0
            if t_first:
                out.setdefault(rep.name, []).append(
                    t_first - rec["t_submit"])
        return out

    def summary(self) -> dict:
        """Router counters, per-replica p99 TTFT, NIC totals and each
        replica's engine stats."""
        for rid in list(self._records):
            self.done(rid)           # fold just-finished completions in
        p99 = {name: float(np.percentile(v, 99))
               for name, v in self.ttft_samples().items()}
        with self._lock:
            self.stats.ttft_p99 = p99
            d = dataclasses.asdict(self.stats)
        with self.nic._cond:
            d["nic"] = {"transfers": self.nic.transfers,
                        "shipped_bytes": self.nic.shipped_bytes}
        d["replicas"] = {rep.name: {"alive": rep.alive,
                                    "stats": dataclasses.asdict(
                                        rep.engine.stats)}
                         for rep in self.replicas}
        return d

    # --------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Stop the monitor, kill and join every worker (a killed run loop
        joins its DMA threads), drain the NIC, close every engine.
        Idempotent."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._monitor.is_alive():
            self._monitor.join()
        for rep in self.replicas:
            rep.engine.hard_kill()
            rep.engine.resume()
            if rep.thread is not None and rep.thread.is_alive():
                rep.thread.join()
        self.nic.shutdown()
        if self.nic.is_alive():
            self.nic.join()
        for rep in self.replicas:
            if not rep.closed:
                rep.engine.close()
                rep.closed = True

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
