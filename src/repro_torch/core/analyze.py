"""Static plan-soundness certifier (DESIGN.md §13).

TURNIP's premise is that the runtime may execute a MEMGRAPH in *any*
dependency-respecting order, so plan correctness is a universally
quantified claim: byte-exactness, tier coherence, and budget feasibility
must hold for **all** topological orders. ``validate()`` replays one
order and the differential harness samples a few more; this module
closes the gap by *proving* the claim over the transitive order itself.

Three passes over a built :class:`~repro_torch.core.memgraph.MemGraph`:

1. **Happens-before race detector** (:func:`_pass_device_races`) — the
   DAG's transitive order is materialized as descendant bitsets
   (``MemGraph.reachability``); every pair of vertices touching
   overlapping device extents with at least one writer, and every
   operand read, must be ordered. Generalizes
   ``MemGraph._check_safe_overwrites`` from overwrites to all
   read/write/overwrite interleavings (lock-group accumulations exempt,
   as at runtime).

2. **Tier-lifetime linter** (:func:`_pass_tier_lifetimes`) — per host
   key, an abstract created → resident ⇄ spilled → freed state machine
   interpreted over *all* orders: every access must be reachable from
   the key's creating OFFLOAD, every copy-releasing drop must be
   reachable from every reader (use-after-drop, drop-before-last-reader,
   stale-twin read-through racing the blob's deletion, double-spill).

3. **Worst-case budget soundness** (:func:`_pass_budgets`) — host/disk
   occupancy under *any* legal order is bounded by the max-weight
   antichain of residency intervals (two residencies can be
   simultaneously live iff neither's release happens-before the other's
   admit; pairwise-incomparable residencies are jointly realizable via
   the down-closure of their admits, so the bound is exact). Computed
   exactly by a min-flow/max-antichain dual (weighted Dilworth) and
   compared against ``host_capacity``/``disk_capacity`` — upgrading the
   single-order replay in ``validate(host_capacity=)``.

Every finding is a typed :class:`PlanHazard` carrying a **witness
schedule**: a full topological order (plus, for budget hazards, a prefix
and expected occupancy) that the differential harness replays to confirm
the hazard dynamically — static findings stay falsifiable.

CLI: ``python -m repro_torch.core.analyze`` certifies the seeded example-plan
corpus (the same taskgraph distribution the fuzz suites draw from) and
exits nonzero on any hazard; CI gates on it.
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import deque
from typing import Any, Callable, Iterable, Sequence

from .memgraph import MemGraph, MemOp, RaceError, STORE_OPS

__all__ = [
    "PlanHazard", "Certificate", "PlanCertificationError", "certify",
    "max_weight_antichain", "recover_residencies", "replay_occupancy",
    "Residency", "main",
]

# hazard kinds (PlanHazard.kind)
DEVICE_RACE = "device-race"                # unordered overlapping accesses
USE_AFTER_OVERWRITE = "use-after-overwrite"  # read ordered after clobber
OPERAND_UNORDERED = "operand-unordered"    # read not ordered after producer
ACCUM_UNINIT = "accumulator-uninitialized"  # ADD_INTO before its ALLOC0
TIER_BEFORE_CREATE = "tier-access-before-create"
USE_AFTER_DROP = "use-after-drop"
STALE_TWIN = "stale-twin"                  # read-through races twin deletion
DOUBLE_SPILL = "double-spill"
HOST_BUDGET = "host-budget"
DISK_BUDGET = "disk-budget"
STRUCTURE = "structure"


@dataclasses.dataclass(frozen=True)
class PlanHazard:
    """One certified finding: the claim, the vertices, and a witness
    schedule that exhibits it dynamically.

    ``witness`` is a full topological order of the graph. For
    ``witness_kind == 'race'`` replaying it through the sequential
    interpreter must raise (or diverge from the oracle); for
    ``'occupancy'`` the ``tier`` occupancy replayed over the witness
    reaches ``expect_units > capacity`` within the first ``prefix``
    vertices; for ``'stall'`` (the liveness certifier, DESIGN.md §14) the
    directed scheduler replaying the first ``prefix`` vertices with the
    blocking admission discipline reaches a bounded-timeout stall, with
    ``lease`` naming the contended pool share. ``confirmable`` is False
    for hazards whose bad interleaving is dynamically silent (e.g. a
    double-spill deduplicated by the store) — still plan bugs, but not
    replay-falsifiable."""

    kind: str
    vertices: tuple[int, ...]
    detail: str
    witness: tuple[int, ...] = ()
    witness_kind: str = "race"
    confirmable: bool = True
    tier: str | None = None
    prefix: int = 0
    expect_units: int = 0
    capacity: int | None = None
    lease: str | None = None

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"


@dataclasses.dataclass
class Certificate:
    """The certifier's verdict over one plan."""

    ok: bool
    hazards: list[PlanHazard]
    n_vertices: int
    host_capacity: int | None = None
    disk_capacity: int | None = None
    worst_host_units: int = 0          # max-antichain host occupancy bound
    worst_disk_units: int = 0
    n_host_residencies: int = 0
    n_disk_blobs: int = 0
    n_pairs_checked: int = 0           # overlapping device pairs examined

    def summary(self) -> str:
        head = ("CLEAN" if self.ok else
                f"{len(self.hazards)} hazard(s)")
        lines = [
            f"certificate: {head} over {self.n_vertices} vertices "
            f"({self.n_pairs_checked} overlapping extent pairs, "
            f"{self.n_host_residencies} host residencies, "
            f"{self.n_disk_blobs} disk blobs)",
            f"  worst-case host occupancy {self.worst_host_units} units"
            + (f" / capacity {self.host_capacity}"
               if self.host_capacity is not None else " (unbounded)"),
            f"  worst-case disk occupancy {self.worst_disk_units} units"
            + (f" / capacity {self.disk_capacity}"
               if self.disk_capacity is not None else " (unbounded)"),
        ]
        lines += [f"  {h}" for h in self.hazards]
        return "\n".join(lines)


class PlanCertificationError(RaceError):
    """A compiled plan failed certification (compiler bug: fail loudly)."""

    def __init__(self, certificate: Certificate) -> None:
        super().__init__(certificate.summary())
        self.certificate = certificate


# --------------------------------------------------------------------------
# witness schedules
# --------------------------------------------------------------------------
def _witness_order(mg: MemGraph, early: Iterable[int],
                   late: Iterable[int]) -> tuple[int, ...]:
    """A topological order scheduling ``early`` (and their ancestor
    closures) as soon as possible and ``late`` (and their descendant
    closures) as late as possible — the adversarial schedule that turns
    an unordered hazard pair into a concrete interleaving. Ties follow
    the compile-time seq so the witness stays close to a real schedule."""
    bitpos, desc = mg.reachability()
    early = set(early)
    late_mask = 0
    for m in late:
        late_mask |= (1 << bitpos[m]) | desc[m]
    ebits = [bitpos[e] for e in early]

    def key(m: int) -> tuple[int, int, int]:
        if (late_mask >> bitpos[m]) & 1:
            tier = 2
        elif m in early or any((desc[m] >> b) & 1 for b in ebits):
            tier = 0
        else:
            tier = 1
        return (tier, mg.vertices[m].seq, m)

    return tuple(mg.topo_order(key=key))


def replay_occupancy(mg: MemGraph, order: Sequence[int],
                     tier: str = "host") -> list[int]:
    """Tier occupancy (units) after each prefix of ``order``, with the
    runtime store's semantics: OFFLOAD/LOAD admit a key's bytes, SPILL
    releases them (a spill of a non-resident key is a no-op, matching
    ``TieredStore``; the first real spill creates the immutable disk
    blob, a drop releases every copy). The dynamic confirmation for
    occupancy witnesses — ``TieredStore`` itself does not enforce plan
    budgets at runtime."""
    occ_host = occ_disk = 0
    res_units: dict[int, int] = {}
    blob_units: dict[int, int] = {}
    out: list[int] = []
    for m in order:
        v = mg.vertices[m]
        if v.op == MemOp.OFFLOAD:
            if m not in res_units:
                res_units[m] = v.size
                occ_host += v.size
        elif v.op == MemOp.LOAD:
            key = v.operands[0] if v.operands else m
            if key not in res_units:
                res_units[key] = v.size
                occ_host += v.size
        elif v.op == MemOp.SPILL:
            key = v.operands[0] if v.operands else m
            if v.params.get("drop"):
                occ_host -= res_units.pop(key, 0)
                occ_disk -= blob_units.pop(key, 0)
            else:
                units = res_units.pop(key, 0)
                occ_host -= units
                if units and key not in blob_units:
                    blob_units[key] = units
                    occ_disk += units
        out.append(occ_host if tier == "host" else occ_disk)
    return out


# --------------------------------------------------------------------------
# max-weight antichain (weighted Dilworth via min-flow)
# --------------------------------------------------------------------------
def _min_flow(weights: Sequence[int], prec: Iterable[tuple[int, int]]) -> int:
    """Minimum flow covering element ``i`` at least ``weights[i]`` times,
    where a unit of flow may traverse any chain of the partial order
    ``prec`` (``(i, j)`` ⇒ i wholly precedes j). By LP duality this
    equals the maximum-weight antichain. Classic reduction: start from
    the feasible flow routing ``w_i`` through each element, then cancel
    as much as possible with a max-flow from sink to source over the
    residual network (lower bounds block cancellation below ``w_i``)."""
    n = len(weights)
    if n == 0:
        return 0
    total = sum(weights)
    big = total + 1
    S, T = 2 * n, 2 * n + 1
    cap: dict[tuple[int, int], int] = {}
    adj: dict[int, set[int]] = {}

    def arc(u: int, v: int, c: int) -> None:
        cap[(u, v)] = cap.get((u, v), 0) + c
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)

    for i, w in enumerate(weights):
        arc(S, 2 * i, big)          # s→in: residual of the w-unit route
        arc(2 * i, S, w)
        arc(2 * i, 2 * i + 1, big)  # in→out: flow w at lower bound w
        arc(2 * i + 1, T, big)      # out→t
        arc(T, 2 * i + 1, w)
    for i, j in prec:
        arc(2 * i + 1, 2 * j, big)  # a chain may continue i → j
    cancelled = 0
    while True:                      # Edmonds–Karp from T to S
        parent: dict[int, int | None] = {T: None}
        dq = deque([T])
        while dq and S not in parent:
            u = dq.popleft()
            for v in adj.get(u, ()):
                if v not in parent and cap.get((u, v), 0) > 0:
                    parent[v] = u
                    dq.append(v)
        if S not in parent:
            return total - cancelled
        path = []
        v = S
        while parent[v] is not None:
            u = parent[v]
            assert u is not None
            path.append((u, v))
            v = u
        b = min(cap[(u, w)] for u, w in path)
        for u, w in path:
            cap[(u, w)] -= b
            cap[(w, u)] = cap.get((w, u), 0) + b
        cancelled += b


def max_weight_antichain(
        weights: Sequence[int],
        prec: Iterable[tuple[int, int]]) -> tuple[int, list[int]]:
    """``(best, members)``: the maximum total weight of any antichain of
    the partial order ``prec`` over ``range(len(weights))``, and one
    antichain achieving it. Members are recovered by peeling: an element
    belongs to some optimum iff fixing it (and restricting to its
    incomparables) preserves the target weight."""
    comparable = set()
    prec = list(prec)
    for a, b in prec:
        comparable.add((a, b))
        comparable.add((b, a))

    def value(sub: list[int]) -> int:
        pos = {g: i for i, g in enumerate(sub)}
        return _min_flow([weights[g] for g in sub],
                         [(pos[a], pos[b]) for a, b in prec
                          if a in pos and b in pos])

    live = [i for i in range(len(weights)) if weights[i] > 0]
    best = value(live)
    members: list[int] = []
    target = best
    while target > 0 and live:
        i = live[0]
        rest = [j for j in live[1:] if (i, j) not in comparable]
        if weights[i] + value(rest) == target:
            members.append(i)
            live = rest
            target -= weights[i]
        else:
            live = live[1:]
    return best, members


# --------------------------------------------------------------------------
# residency recovery (tier intervals from the graph alone)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Residency:
    """One tenancy of a tier: ``units`` held from ``admit`` until
    ``release`` (None = held to the end of the plan)."""

    key: int
    admit: int
    release: int | None
    units: int


def recover_residencies(
        mg: MemGraph) -> tuple[list[Residency], list[Residency]]:
    """Recover ``(host, disk)`` residency intervals statically. Host: an
    OFFLOAD/LOAD of a key opens a tenancy, the next SPILL of the key
    that is actually reachable from the admit closes it (an unreachable
    release cannot be relied on in all orders — the tenancy stays open,
    which is exactly the conservative reading the budget pass needs).
    Disk: the first real SPILL creates the blob, a reachable drop
    releases it."""
    events: dict[int, list[tuple[int, str, int]]] = {}
    for m, v in mg.vertices.items():
        if v.op == MemOp.OFFLOAD:
            events.setdefault(m, []).append((v.seq, "admit", m))
        elif v.op == MemOp.LOAD:
            key = v.operands[0] if v.operands else m
            events.setdefault(key, []).append((v.seq, "admit", m))
        elif v.op == MemOp.SPILL:
            key = v.operands[0] if v.operands else m
            kind = "drop" if v.params.get("drop") else "spill"
            events.setdefault(key, []).append((v.seq, kind, m))
    host: list[Residency] = []
    disk: list[Residency] = []
    for key, evs in events.items():
        evs.sort()
        admit: int | None = None
        blob: int | None = None
        blob_done = False
        for _, kind, m in evs:
            if kind == "admit":
                if admit is None:
                    admit = m
            else:
                if admit is not None and mg.happens_before(admit, m):
                    host.append(Residency(key, admit,
                                          m, mg.vertices[admit].size))
                    admit = None
                if kind == "spill" and blob is None and not blob_done:
                    blob = m
                elif kind == "drop" and blob is not None:
                    if mg.happens_before(blob, m):
                        disk.append(Residency(key, blob, m,
                                              mg.vertices[blob].size))
                        blob = None
                        blob_done = True
        if admit is not None:
            host.append(Residency(key, admit, None,
                                  mg.vertices[admit].size))
        if blob is not None:
            disk.append(Residency(key, blob, None, mg.vertices[blob].size))
    return host, disk


# --------------------------------------------------------------------------
# the certifier
# --------------------------------------------------------------------------
class _Cert:
    def __init__(self, mg: MemGraph, host_capacity: int | None,
                 disk_capacity: int | None, max_hazards: int) -> None:
        self.mg = mg
        self.host_capacity = host_capacity
        self.disk_capacity = disk_capacity
        self.max_hazards = max_hazards
        self.hazards: list[PlanHazard] = []
        self.n_pairs = 0
        self._seen: set[tuple[Any, ...]] = set()

    def full(self) -> bool:
        return len(self.hazards) >= self.max_hazards

    def emit(self, kind: str, vertices: tuple[int, ...], detail: str,
             **kw: Any) -> None:
        dedup = (kind,) + tuple(sorted(vertices))
        if dedup in self._seen or self.full():
            return
        self._seen.add(dedup)
        self.hazards.append(PlanHazard(kind, vertices, detail, **kw))

    # ---- pass 1: device extents -------------------------------------
    def pass_device_races(self) -> None:
        mg = self.mg
        before = mg.happens_before
        readers_of: dict[int, list[int]] = {}
        by_dev: dict[int, list[int]] = {}
        for m, v in mg.vertices.items():
            if v.loc is not None:
                by_dev.setdefault(v.loc.device, []).append(m)
            for o in dict.fromkeys(v.operands):
                ov = mg.vertices.get(o)
                if ov is None:
                    self.emit(STRUCTURE, (m,),
                              f"vertex {m} reads unknown operand {o}",
                              confirmable=False)
                    continue
                if ov.loc is None:
                    continue           # a tier access: pass 2's problem
                readers_of.setdefault(o, []).append(m)
                if m != o and not before(o, m):
                    # in some (or every) order m reads o's extent before
                    # o has written it
                    self.emit(
                        OPERAND_UNORDERED, (o, m),
                        f"vertex {m} ({v.op.value}) reads operand {o} "
                        f"without a dependency path from it",
                        witness=_witness_order(mg, {m}, {o}))

        # streaming accumulators: each ADD_INTO reads (and its JOIN
        # publishes) the accumulator extent ALLOC0 must have zeroed first
        alloc0s: dict[Any, list[int]] = {}
        for m, v in mg.vertices.items():
            if v.op == MemOp.ALLOC0:
                alloc0s.setdefault(v.lock_group, []).append(m)
        for m, v in mg.vertices.items():
            if v.op != MemOp.ADD_INTO:
                continue
            inits = alloc0s.get(v.lock_group, [])
            if not any(before(a, m) for a in inits):
                self.emit(
                    ACCUM_UNINIT, (m,) + tuple(inits),
                    f"add_into {m} may run before its accumulator is "
                    f"zero-initialized (lock group {v.lock_group})",
                    witness=_witness_order(mg, {m}, set(inits)))

        for dev, ms in by_dev.items():
            ms.sort(key=lambda m: mg.vertices[m].seq)
            for i, m1 in enumerate(ms):
                v1 = mg.vertices[m1]
                for m2 in ms[i + 1:]:
                    v2 = mg.vertices[m2]
                    if not v1.loc.overlaps(v2.loc):
                        continue
                    if (v1.lock_group is not None
                            and v1.lock_group == v2.lock_group):
                        continue       # commutative accumulation (§B)
                    self.n_pairs += 1
                    if before(m1, m2):
                        self._check_overwrite(m1, m2, readers_of)
                    elif before(m2, m1):
                        self._check_overwrite(m2, m1, readers_of)
                    else:
                        self._ww_race(m1, m2, readers_of)
                    if self.full():
                        return

    def _reader_exempt(self, r: int, w: int) -> bool:
        rv, wv = self.mg.vertices[r], self.mg.vertices[w]
        return (rv.lock_group is not None
                and rv.lock_group == wv.lock_group)

    def _check_overwrite(self, e: int, later: int,
                         readers_of: dict[int, list[int]]) -> None:
        """``later`` overwrites ``e``'s extent: every reader of ``e``
        must happen before it (the safe-overwrite rule, paper §4)."""
        mg, before = self.mg, self.mg.happens_before
        for r in readers_of.get(e, ()):
            if r == later or before(r, later):
                continue
            if self._reader_exempt(r, later):
                continue
            if before(later, r):
                self.emit(
                    USE_AFTER_OVERWRITE, (e, later, r),
                    f"vertex {r} reads {e}'s extent "
                    f"{mg.vertices[e].loc} strictly after writer {later} "
                    f"overwrites it — wrong bytes in every order",
                    witness=_witness_order(mg, {later}, {r}))
            else:
                self.emit(
                    DEVICE_RACE, (e, later, r),
                    f"reader {r} of {e}'s extent {mg.vertices[e].loc} "
                    f"is unordered with overwriting writer {later}",
                    witness=_witness_order(mg, {e}, {r}))
            if self.full():
                return

    def _ww_race(self, m1: int, m2: int,
                 readers_of: dict[int, list[int]]) -> None:
        """Unordered writers of overlapping extents. Witness defers a
        reader of whichever writer can be clobbered first, so the replay
        observes the corruption; with no observable reader the race is
        a dead-store conflict (still a plan bug, silently reordered)."""
        mg, before = self.mg, self.mg.happens_before
        for own, other in ((m1, m2), (m2, m1)):
            for r in readers_of.get(own, ()):
                if (r != other and not before(r, other)
                        and not self._reader_exempt(r, other)):
                    self.emit(
                        DEVICE_RACE, (m1, m2, r),
                        f"writers {m1} and {m2} of overlapping extents "
                        f"{mg.vertices[m1].loc} / {mg.vertices[m2].loc} "
                        f"are unordered (reader {r} observes)",
                        witness=_witness_order(mg, {own}, {r}))
                    return
        self.emit(DEVICE_RACE, (m1, m2),
                  f"writers {m1} and {m2} of overlapping extents "
                  f"{mg.vertices[m1].loc} / {mg.vertices[m2].loc} are "
                  f"unordered (no surviving reader: dead-store race)",
                  witness=_witness_order(mg, {m2}, {m1}),
                  confirmable=False)

    # ---- pass 2: tier lifetimes -------------------------------------
    def pass_tier_lifetimes(self) -> None:
        mg, before = self.mg, self.mg.happens_before
        creators: dict[int, list[int]] = {}
        readers: dict[int, list[int]] = {}    # RELOAD/LOAD: fail loudly
        spills: dict[int, list[int]] = {}
        drops: dict[int, list[int]] = {}
        for m, v in mg.vertices.items():
            if v.op == MemOp.OFFLOAD:
                creators.setdefault(m, []).append(m)
            elif v.op == MemOp.RELOAD and v.operands:
                readers.setdefault(v.operands[0], []).append(m)
            elif v.op == MemOp.LOAD:
                readers.setdefault(
                    v.operands[0] if v.operands else m, []).append(m)
            elif v.op == MemOp.SPILL:
                key = v.operands[0] if v.operands else m
                dst = drops if v.params.get("drop") else spills
                dst.setdefault(key, []).append(m)
        keys = set(creators) | set(readers) | set(spills) | set(drops)
        for key in sorted(keys):
            cs = creators.get(key, [])
            accesses = (readers.get(key, []) + spills.get(key, [])
                        + drops.get(key, []))
            loud = set(readers.get(key, ()))   # raise when key is absent
            if not cs:
                for a in accesses:
                    self.emit(
                        TIER_BEFORE_CREATE, (a,),
                        f"vertex {a} accesses host key {key} which no "
                        f"OFFLOAD ever creates",
                        witness=_witness_order(mg, {a}, set()),
                        confirmable=a in loud)
                continue
            c = cs[0]
            for a in accesses:
                if not before(c, a):
                    self.emit(
                        TIER_BEFORE_CREATE, (c, a),
                        f"vertex {a} ({mg.vertices[a].op.value}) accesses "
                        f"host key {key} without a dependency path from "
                        f"its creating offload {c}",
                        witness=_witness_order(mg, {a}, {c}),
                        confirmable=a in loud)
            for d in drops.get(key, []):
                for a in [c] + [x for x in accesses if x != d]:
                    if before(a, d):
                        continue
                    loud_a = a in loud
                    if before(d, a):
                        self.emit(
                            USE_AFTER_DROP, (d, a),
                            f"vertex {a} accesses host key {key} strictly "
                            f"after drop {d} released every copy "
                            f"(drop-before-last-reader)",
                            witness=_witness_order(mg, {d}, {a}),
                            confirmable=loud_a)
                    else:
                        kind = STALE_TWIN if loud_a else USE_AFTER_DROP
                        self.emit(
                            kind, (d, a),
                            f"vertex {a} ({mg.vertices[a].op.value}) of "
                            f"host key {key} is unordered with drop {d}: "
                            f"its read-through races the twin's deletion",
                            witness=_witness_order(mg, {d}, {a}),
                            confirmable=loud_a)
            ss = spills.get(key, [])
            for i, s1 in enumerate(ss):
                for s2 in ss[i + 1:]:
                    if not (before(s1, s2) or before(s2, s1)):
                        self.emit(
                            DOUBLE_SPILL, (s1, s2),
                            f"spills {s1} and {s2} of host key {key} are "
                            f"unordered: the per-key create/free total "
                            f"order the budget replay relies on breaks",
                            witness=_witness_order(mg, {s2}, {s1}),
                            confirmable=False)
            if self.full():
                return

    # ---- pass 3: worst-case budgets ---------------------------------
    def pass_budgets(self) -> tuple[int, int, int, int]:
        mg, before = self.mg, self.mg.happens_before
        host, disk = recover_residencies(mg)

        def bound(res: list[Residency], cap: int | None, tier: str,
                  kind: str) -> int:
            if not res:
                return 0
            prec = [(i, j)
                    for i, ri in enumerate(res)
                    for j, rj in enumerate(res)
                    if i != j and ri.release is not None
                    and before(ri.release, rj.admit)]
            weights = [r.units for r in res]
            if cap is None:
                worst, _ = max_weight_antichain(weights, prec)
                return worst
            worst, members = max_weight_antichain(weights, prec)
            if worst > cap:
                admits = [res[i].admit for i in members]
                bitpos, desc = mg.reachability()
                abits = [bitpos[a] for a in admits]
                down = {m for m in mg.vertices
                        if m in admits
                        or any((desc[m] >> b) & 1 for b in abits)}
                order = mg.topo_order(
                    key=lambda m: (0 if m in down else 1,
                                   mg.vertices[m].seq, m))
                self.emit(
                    kind, tuple(admits),
                    f"{tier}-tier budget unsound: residencies admitted by "
                    f"{admits} can be simultaneously live "
                    f"({worst} units > capacity {cap})",
                    witness=tuple(order), witness_kind="occupancy",
                    tier=tier, prefix=len(down), expect_units=worst,
                    capacity=cap)
            return worst
        worst_host = bound(host, self.host_capacity, "host", HOST_BUDGET)
        worst_disk = bound(disk, self.disk_capacity, "disk", DISK_BUDGET)
        return worst_host, worst_disk, len(host), len(disk)


def certify(mg: MemGraph, *, host_capacity: int | None = None,
            disk_capacity: int | None = None,
            max_hazards: int = 64) -> Certificate:
    """Certify a built MEMGRAPH: prove (or refute, with witness
    schedules) that every dependency-respecting execution order is
    race-free, tier-coherent, and within the host/disk budgets."""
    cert = Certificate(ok=True, hazards=[], n_vertices=len(mg),
                       host_capacity=host_capacity,
                       disk_capacity=disk_capacity)
    try:
        mg.topo_order()
    except RaceError:
        cert.ok = False
        cert.hazards.append(PlanHazard(
            STRUCTURE, (), "MEMGRAPH contains a cycle", confirmable=False))
        return cert
    for m, v in mg.vertices.items():
        if v.op in STORE_OPS and v.loc is not None:
            cert.hazards.append(PlanHazard(
                STRUCTURE, (m,), f"{v.op.value} {m} has a device loc",
                confirmable=False))
        elif v.op not in STORE_OPS and v.loc is None:
            cert.hazards.append(PlanHazard(
                STRUCTURE, (m,), f"{v.op.value} {m} has no device loc",
                confirmable=False))
    c = _Cert(mg, host_capacity, disk_capacity, max_hazards)
    c.hazards = cert.hazards
    c.pass_device_races()
    c.pass_tier_lifetimes()
    (cert.worst_host_units, cert.worst_disk_units,
     cert.n_host_residencies, cert.n_disk_blobs) = c.pass_budgets()
    cert.n_pairs_checked = c.n_pairs
    cert.ok = not cert.hazards
    return cert


# --------------------------------------------------------------------------
# CLI: certify the seeded example-plan corpus (CI gate)
# --------------------------------------------------------------------------
def _corpus_taskgraph(rng: Any) -> Any:
    """The fuzz suites' taskgraph distribution (tests/helpers.py),
    restated here so the CLI is self-contained for CI."""
    from .taskgraph import TaskGraph
    shape = (4, 4)
    unary = ["relu", "transpose", "copy"]
    binary = ["add", "mul", "matmul", "matmul_t"]
    n_dev = rng.randint(1, 3)
    tg = TaskGraph()
    tids = []
    for i in range(rng.randint(1, 3)):
        for d in range(n_dev):
            tids.append(tg.add_input(d, shape, name=f"in{d}.{i}"))
    for i in range(rng.randint(6, 18)):
        d = rng.randrange(n_dev)
        if rng.random() < 0.5:
            tids.append(tg.add_compute(d, (rng.choice(tids),), shape,
                                       op=rng.choice(unary), name=f"v{i}"))
        else:
            tids.append(tg.add_compute(
                d, (rng.choice(tids), rng.choice(tids)), shape,
                op=rng.choice(binary), name=f"v{i}"))
        if i % 7 == 6 and len(tids) >= 4:
            parts = rng.sample(tids, k=min(len(tids), rng.randint(2, 4)))
            tids.append(tg.add_reduce(d, parts, streaming=True,
                                      name=f"r{i}"))
    return tg


def main(argv: Sequence[str] | None = None) -> int:
    import random as pyrandom

    from .build import BuildConfig, MemgraphOOM, build_memgraph

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analyze",
        description="Certify the seeded example-plan corpus: every "
                    "buildable plan must prove clean for all execution "
                    "orders (DESIGN.md §13).")
    p.add_argument("--seeds", type=int, default=24,
                   help="corpus size (default 24)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print one summary line per plan")
    args = p.parse_args(argv)

    host_caps = (None, 1, 2, 3)
    disk_caps = (None, 0, 2, 4, 50)
    n_clean = n_oom = 0
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
        cert = certify(res.memgraph, host_capacity=host_cap,
                       disk_capacity=disk_cap)
        prof = res.memgraph.host_tier_profile()
        if cert.ok and cert.worst_host_units < prof["peak_units"]:
            cert.ok = False            # the bound must dominate the replay
            cert.hazards.append(PlanHazard(
                STRUCTURE, (), "antichain bound below replayed peak "
                f"({cert.worst_host_units} < {prof['peak_units']})",
                confirmable=False))
        if cert.ok:
            n_clean += 1
            if args.verbose:
                print(f"seed {seed}: clean "
                      f"(host≤{cert.worst_host_units}"
                      f"/{host_cap if host_cap is not None else '∞'}, "
                      f"disk≤{cert.worst_disk_units}"
                      f"/{disk_cap if disk_cap is not None else '∞'})")
        else:
            failed += 1
            print(f"seed {seed}: FAILED certification")
            print(cert.summary())
    print(f"corpus: {n_clean} plans certified clean, {n_oom} rejected at "
          f"compile time, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
