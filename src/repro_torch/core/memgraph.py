"""MEMGRAPH intermediate representation (paper §4).

A MEMGRAPH is a *dependency* graph (not a dataflow graph): an edge
``u -> v`` means only that ``v`` may not start until ``u`` has completed.
Two edge kinds exist:

* ``DATA`` — inherited from the TASKGRAPH (or created by offload/reload
  insertion): ``v`` consumes the bytes produced by ``u``;
* ``MEM`` — a memory dependency inserted so that a vertex safely overwrites
  the previous occupant of its assigned memory location (paper §4/§6).

Every vertex's output is bound at compile time to a :class:`Loc` — a
``(device, offset, size)`` extent in that device's arena — except OFFLOAD
vertices, whose output lives in the host store. There is no dynamic
allocation at runtime (paper §5): any execution order that respects the
dependencies reads and writes exactly the planned extents.

The class also carries validation helpers used heavily by the test suite:
acyclicity, safe-overwrite race-freedom (paper §7), and a slot-table
interpreter that executes the graph under an arbitrary topological order to
prove order-independence of the final outputs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable

__all__ = ["MemOp", "STORE_OPS", "DepKind", "Loc", "MemVertex", "MemGraph",
           "RaceError"]


class RaceError(AssertionError):
    """A race condition or cycle detected during MEMGRAPH validation."""


class MemOp(str, enum.Enum):
    INPUT = "input"        # load a graph input from the host store
    COMPUTE = "compute"
    TRANSFER = "transfer"  # device-to-device
    OFFLOAD = "offload"    # device -> host   (output in host store)
    RELOAD = "reload"      # host -> device
    SPILL = "spill"        # host -> disk  (second hop of a tiered eviction;
    #                        params={'drop': True} releases dead bytes for free)
    LOAD = "load"          # disk -> host  (first hop of a two-hop reload)
    ALLOC0 = "alloc0"      # zero-init of a streaming-reduce accumulator (§B)
    ADD_INTO = "add_into"  # commutative accumulation into a locked loc (§B)
    JOIN = "join"          # completion marker of a streaming-reduce group
    XFER = "xfer"          # host -> remote host over the NIC (inter-replica
    #                        KV migration; priced by the simulator's sixth
    #                        channel — the plan builder never emits it)


# ops whose output lives in a store tier, not a device extent (loc is None)
STORE_OPS = frozenset({MemOp.OFFLOAD, MemOp.SPILL, MemOp.LOAD})


@dataclasses.dataclass(frozen=True)
class Loc:
    """An extent in a device arena. ``size`` is in abstract units."""

    device: int
    offset: int
    size: int

    @property
    def key(self) -> tuple[int, int]:
        return (self.device, self.offset)

    def overlaps(self, other: "Loc") -> bool:
        return (self.device == other.device
                and self.offset < other.offset + other.size
                and other.offset < self.offset + self.size)


class DepKind(str, enum.Enum):
    DATA = "data"
    MEM = "mem"


@dataclasses.dataclass
class MemVertex:
    mid: int
    op: MemOp
    device: int                      # device whose engine executes the vertex
    src_tid: int | None = None       # originating TASKGRAPH vertex, if any
    loc: Loc | None = None           # output extent (None for OFFLOAD)
    seq: int = -1                    # simulation execution order (fixed-exec order)
    op_name: str = ""                # runtime op-registry name
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    flops: float = 0.0
    size: int = 0                    # output size in units (host size for OFFLOAD)
    nbytes: int = 0                  # output size in bytes (for the simulator)
    name: str = ""
    # storage tier an OFFLOAD/RELOAD ultimately talks to: "host" (one hop)
    # or "disk" (this vertex is one leg of a two-hop spill/reload chain).
    # SPILL/LOAD vertices are always tier "disk".
    tier: str = "host"
    # True on a LOAD hoisted ahead of its consumer's horizon by the
    # compiler's PrefetchPlan (the reload pipeline starts before the
    # consumer needs the bytes); False on reactive force-reload LOADs.
    prefetch: bool = False
    lock_group: tuple[int, int] | None = None  # ADD_INTO write-lock key (§B)
    # ordered operand list (mids; duplicates allowed) — dependency *sets* lose
    # operand order, which the runtime needs to bind kernel arguments.
    operands: list[int] = dataclasses.field(default_factory=list)


class MemGraph:
    """Dependency graph with typed edges plus validation/execution helpers."""

    def __init__(self) -> None:
        self.vertices: dict[int, MemVertex] = {}
        self.preds: dict[int, dict[int, DepKind]] = {}
        self.succs: dict[int, dict[int, DepKind]] = {}
        self.superfluous_mem_deps = 0  # mem deps skipped: data dep already there
        self._next_mid = 0
        # memoized transitive order (descendant bitsets); any structural
        # mutation must call _invalidate_reach() or later happens_before()
        # answers describe a graph that no longer exists.
        self._reach: tuple[dict[int, int], dict[int, int]] | None = None

    # -- construction -----------------------------------------------------
    def add_vertex(self, op: MemOp, device: int, **kw: Any) -> int:
        mid = self._next_mid
        self._next_mid += 1
        self.vertices[mid] = MemVertex(mid, op, device, **kw)
        self.preds[mid] = {}
        self.succs[mid] = {}
        self._invalidate_reach()
        return mid

    def remove_vertex(self, mid: int) -> None:
        """Retract a vertex. Unwired vertices (the builder's
        abandoned-prefetch path) simply vanish; wired vertices — plan
        surgery, hazard injection in tests — are detached from *both* edge
        maps so no dangling pred/succ entry survives. Transitive ordering
        implied by the removed vertex is deliberately NOT re-bridged: the
        caller asked for the vertex (and its ordering constraints) to go."""
        for p in self.preds.pop(mid):
            del self.succs[p][mid]
        for s in self.succs.pop(mid):
            del self.preds[s][mid]
        del self.vertices[mid]
        self._invalidate_reach()

    def add_dep(self, u: int, v: int, kind: DepKind) -> None:
        """Add ``u -> v``. A MEM dep duplicating an existing DATA dep is
        superfluous (paper Fig. 5 dashed edge) and is counted, not stored."""
        if u == v:
            return
        existing = self.preds[v].get(u)
        if existing is not None:
            if kind == DepKind.MEM:
                self.superfluous_mem_deps += 1
            elif existing == DepKind.MEM:
                # upgrade MEM -> DATA (data implies the ordering)
                self.preds[v][u] = DepKind.DATA
                self.succs[u][v] = DepKind.DATA
            return
        self.preds[v][u] = kind
        self.succs[u][v] = kind
        self._invalidate_reach()

    def remove_dep(self, u: int, v: int) -> None:
        """Remove the edge ``u -> v`` (hazard injection / plan surgery)."""
        del self.preds[v][u]
        del self.succs[u][v]
        self._invalidate_reach()

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vertices)

    def data_preds(self, v: int) -> list[int]:
        return [u for u, k in self.preds[v].items() if k == DepKind.DATA]

    def data_succs(self, v: int) -> list[int]:
        return [u for u, k in self.succs[v].items() if k == DepKind.DATA]

    def n_edges(self) -> tuple[int, int]:
        data = sum(1 for v in self.preds for k in self.preds[v].values()
                   if k == DepKind.DATA)
        mem = sum(1 for v in self.preds for k in self.preds[v].values()
                  if k == DepKind.MEM)
        return data, mem

    def topo_order(self, key: Callable[[int], Any] | None = None) -> list[int]:
        """Topological order; ``key`` breaks ties (e.g. ``seq`` for the
        fixed-execution ablation, or a PRNG for property tests)."""
        import heapq

        indeg = {m: len(self.preds[m]) for m in self.vertices}
        keyf = key or (lambda m: m)
        heap = [(keyf(m), m) for m, d in indeg.items() if d == 0]
        heapq.heapify(heap)
        order: list[int] = []
        while heap:
            _, m = heapq.heappop(heap)
            order.append(m)
            for s in self.succs[m]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, (keyf(s), s))
        if len(order) != len(self.vertices):
            raise RaceError("MEMGRAPH contains a cycle")
        return order

    # -- validation (paper §7) ----------------------------------------------
    def validate(self, check_races: bool = True,
                 host_capacity: int | None = None,
                 disk_capacity: int | None = None) -> None:
        """Structural validation; ``host_capacity``/``disk_capacity``
        additionally replay the compile-time schedule and check the
        host-tier / disk-tier budgets (units)."""
        self.topo_order()
        for m, v in self.vertices.items():
            if v.op in STORE_OPS:
                if v.loc is not None:
                    raise RaceError(f"{v.op.value} {m} has a device loc")
            elif v.loc is None:
                raise RaceError(f"{v.op} vertex {m} has no loc")
        if host_capacity is not None or disk_capacity is not None:
            prof = self.host_tier_profile()
            if (host_capacity is not None
                    and prof["peak_units"] > host_capacity):
                raise RaceError(
                    f"host-tier budget exceeded: peak {prof['peak_units']} "
                    f"units > capacity {host_capacity}")
            if (disk_capacity is not None
                    and prof["peak_disk_units"] > disk_capacity):
                raise RaceError(
                    f"disk-tier budget exceeded: peak "
                    f"{prof['peak_disk_units']} units > capacity "
                    f"{disk_capacity}")
        if check_races:
            self._check_safe_overwrites()

    def host_tier_profile(self) -> dict[str, int]:
        """Replay the compile-time (seq) schedule, tracking host-tier
        occupancy in units: OFFLOAD and LOAD admit bytes into the host
        arena, SPILL (including drops) releases them. Disk occupancy is
        replayed per host key (``operands[0]``): the first real SPILL of a
        key creates its immutable blob, a drop releases it; LOADs leave the
        blob valid. Conservative w.r.t. runtime orders: every SPILL is
        ordered (by construction in ``build.py``) after the host copy's
        readers and before the tenant that reuses its space, and every
        drop after the blob's readers — per-key create/free is totally
        ordered, so any legal order peaks no higher than this replay."""
        occ = peak = 0
        disk_occ = disk_peak = 0
        on_disk: dict[Any, int] = {}      # host key -> blob units
        spilled = loaded = dropped = prefetched = 0
        for m in sorted(self.vertices, key=lambda m: self.vertices[m].seq):
            v = self.vertices[m]
            if v.op == MemOp.OFFLOAD:
                occ += v.size
            elif v.op == MemOp.LOAD:
                occ += v.size
                loaded += 1
                if v.prefetch:
                    prefetched += 1
            elif v.op == MemOp.SPILL:
                occ -= v.size
                key = v.operands[0] if v.operands else m
                if v.params.get("drop"):
                    dropped += 1
                    disk_occ -= on_disk.pop(key, 0)
                else:
                    spilled += 1
                    if key not in on_disk:
                        on_disk[key] = v.size
                        disk_occ += v.size
            peak = max(peak, occ)
            disk_peak = max(disk_peak, disk_occ)
        return {"peak_units": peak, "final_units": occ,
                "peak_disk_units": disk_peak, "final_disk_units": disk_occ,
                "n_spills": spilled, "n_loads": loaded, "n_drops": dropped,
                "n_prefetches": prefetched}

    # -- transitive order (the certifier's substrate, DESIGN.md §13) --------
    def _invalidate_reach(self) -> None:
        self._reach = None

    def reachability(self) -> tuple[dict[int, int], dict[int, int]]:
        """``(bitpos, desc)``: ``desc[m]`` is an int bitmask with bit
        ``bitpos[x]`` set iff there is a (non-empty) path ``m -> x``.
        Computed once per graph shape in one reverse-topological sweep over
        big-int bitsets and memoized; mutation invalidates the memo."""
        if self._reach is None:
            order = self.topo_order()
            bitpos = {m: i for i, m in enumerate(order)}
            desc: dict[int, int] = {}
            for m in reversed(order):
                bits = 0
                for s in self.succs[m]:
                    bits |= (1 << bitpos[s]) | desc[s]
                desc[m] = bits
            self._reach = (bitpos, desc)
        return self._reach

    def happens_before(self, u: int, v: int) -> bool:
        """True iff ``u`` precedes ``v`` in *every* legal execution order
        (there is a dependency path ``u -> v``). Irreflexive."""
        bitpos, desc = self.reachability()
        return bool(desc[u] >> bitpos[v] & 1)

    def _ancestors(self, dst: int, cache: dict) -> set[int]:
        """The ancestor set of ``dst`` (all vertices with a path to it),
        memoized in ``cache``."""
        anc = cache.get(dst)
        if anc is None:
            anc = set()
            stack = [dst]
            while stack:
                x = stack.pop()
                for p in self.preds[x]:
                    if p not in anc:
                        anc.add(p)
                        stack.append(p)
            cache[dst] = anc
        return anc

    def _reachable(self, srcs: set[int], dst: int, cache: dict) -> bool:
        """Is there a path from any of ``srcs`` to ``dst``? (ancestors of dst)"""
        return bool(srcs & self._ancestors(dst, cache))

    def _check_safe_overwrites(self) -> None:
        """For every pair of vertices whose outputs overlap in memory, one
        must safely overwrite the other: each reader of the earlier writer
        must be an ancestor of the later writer (paper §4). ADD_INTO vertices
        of one lock group commute and are exempt w.r.t. each other.
        O(writers² per extent) — intended for test-sized graphs."""
        order = self.topo_order()
        pos = {m: i for i, m in enumerate(order)}
        cache: dict[int, set[int]] = {}
        by_dev: dict[int, list[int]] = {}
        for m, v in self.vertices.items():
            if v.loc is not None:
                by_dev.setdefault(v.loc.device, []).append(m)
        for dev, ms in by_dev.items():
            ms.sort(key=lambda m: pos[m])
            for i, m1 in enumerate(ms):
                v1 = self.vertices[m1]
                for m2 in ms[i + 1:]:
                    v2 = self.vertices[m2]
                    if not v1.loc.overlaps(v2.loc):
                        continue
                    if (v1.lock_group is not None
                            and v1.lock_group == v2.lock_group):
                        continue  # commutative accumulation (§B)
                    # v2 is the later writer: every reader of v1 (and v1
                    # itself) must be an ancestor of v2.
                    readers = set(self.data_succs(m1)) | {m1}
                    anc = self._ancestors(m2, cache)
                    bad = {r for r in readers if r != m2 and r not in anc
                           and pos[r] < pos[m2]}
                    # A reader *after* v2 in topo pos but not ordered w.r.t.
                    # it is also a race.
                    bad |= {r for r in readers if r != m2 and r not in anc
                            and pos[r] >= pos[m2]
                            and not self._reachable({m2}, r, cache)}
                    if bad:
                        raise RaceError(
                            f"race on dev{dev} {v1.loc}: writer {m2} does not "
                            f"safely overwrite {m1}; unordered readers {bad}")

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        kinds: dict[str, int] = {}
        off_bytes = rel_bytes = spill_bytes = load_bytes = 0
        n_prefetch = prefetch_bytes = 0
        for v in self.vertices.values():
            kinds[v.op.value] = kinds.get(v.op.value, 0) + 1
            if v.op == MemOp.OFFLOAD:
                off_bytes += v.nbytes
            elif v.op == MemOp.RELOAD:
                rel_bytes += v.nbytes
            elif v.op == MemOp.SPILL:
                spill_bytes += v.nbytes
            elif v.op == MemOp.LOAD:
                load_bytes += v.nbytes
                if v.prefetch:
                    n_prefetch += 1
                    prefetch_bytes += v.nbytes
        data, mem = self.n_edges()
        return {
            "n_vertices": len(self),
            "by_op": kinds,
            "data_deps": data,
            "mem_deps": mem,
            "superfluous_mem_deps": self.superfluous_mem_deps,
            "offload_bytes": off_bytes,
            "reload_bytes": rel_bytes,
            "disk_spill_bytes": spill_bytes,
            "disk_load_bytes": load_bytes,
            "n_prefetch_loads": n_prefetch,
            "prefetch_bytes": prefetch_bytes,
        }
