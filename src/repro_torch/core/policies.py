"""Simulated device arenas + the paper's "unobtrusiveness" policies (§C).

The BUILDMEMGRAPH compiler never allocates real memory: it maintains, per
device, an :class:`Arena` — an interval map of ``[0, capacity)`` in abstract
units — through special malloc/free variants (paper Fig. 9). The arena tracks,
for every byte range, who owns it now and who wrote it last, so the builder
can emit the safe-overwrite memory dependencies.

Two policy hooks (paper §C):

* **placement** — among free regions able to hold an allocation, prefer the
  one whose last use is furthest in the past (maximizes the chance that the
  safe-overwrite dependencies are already satisfied when the runtime wants to
  dispatch the new writer);
* **eviction** — among candidate regions requiring eviction, prefer the one
  maximizing the *minimum* next-use distance of any evicted tensor (Belady;
  the paper's generalization to variable-size tensors). ``lru`` and ``random``
  victims are provided for the §C ablation.

:class:`HostPlan` extends the same discipline one tier down (beyond-paper,
DESIGN.md §10): the host arena itself is an :class:`Arena` of
``host_capacity`` units shared by every device, whose tenants are the host
copies created by OFFLOAD (and restaged by LOAD) vertices. When an
admission cannot be placed, the plan picks the host copy whose next
schedule-known use is furthest away (Belady over the serialized vertex
list; copies backed by a live device tensor or terminal outputs count as
"never needed" and spill first) and asks the builder to emit the SPILL
vertex that frees its extent.

:class:`PrefetchPlan` (DESIGN.md §11) closes the remaining reactive gap:
pass 1 of the build emits disk→host LOADs at force-reload time — exactly
the stall the paper says the compiler's whole-future knowledge should
hide. The plan walks pass 1's schedule *backward*: for every reactive
LOAD it finds the earliest execution point from which the restaged bytes
fit in the host tier through every intervening window (capped by
``prefetch_distance`` and by the point the disk blob comes into
existence), charging each committed hoist against the occupancy profile
so simultaneous prefetches stay jointly feasible. Pass 2 replays the
build and emits the hoisted LOADs at those points — pipelined
``disk→host→device`` chains that start ahead of the consumer's horizon.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Iterable

__all__ = ["Extent", "Arena", "PlacementDecision", "EvictionDecision",
           "HostEntry", "HostPlan", "PrefetchPlan", "PrefetchRecord", "INF"]

INF = float("inf")


@dataclasses.dataclass
class Extent:
    """A maximal run of bytes with uniform ownership state."""

    offset: int
    size: int
    owner: int | None = None          # memgraph vertex occupying it; None = free
    last_writers: set[int] = dataclasses.field(default_factory=set)
    last_use: int = -1                # seq when last freed/read (free extents)
    pinned: int = 0                   # pin refcount (eviction-exempt)
    # Writers/direct-deps of these bytes *before* the current owner. If the
    # owner's reservation is cancelled before it ever writes, these (not the
    # owner!) are what the next tenant must order against.
    carried_writers: set[int] = dataclasses.field(default_factory=set)
    carried_direct: set[int] = dataclasses.field(default_factory=set)
    # for FREE extents: non-writer ordering obligations (e.g. a pending
    # offload still reading the stale bytes) inherited by the next tenant
    last_direct: set[int] = dataclasses.field(default_factory=set)

    @property
    def end(self) -> int:
        return self.offset + self.size

    @property
    def free(self) -> bool:
        return self.owner is None


@dataclasses.dataclass
class PlacementDecision:
    offset: int
    size: int
    prev_writers: set[int]            # real byte-writers: expand to their readers
    direct_deps: set[int] = dataclasses.field(default_factory=set)  # no expansion


@dataclasses.dataclass
class EvictionDecision:
    offset: int
    size: int
    prev_writers: set[int]            # writers of covered *free* bytes
    victims: list[int]                # owner mids to offload (executed)
    cancelled: list[int]              # owner mids whose reservation is cancelled


class Arena:
    """Interval map over ``[0, capacity)`` for one device."""

    def __init__(self, device: int, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("arena capacity must be positive")
        self.device = device
        self.capacity = capacity
        self.extents: list[Extent] = [Extent(0, capacity)]
        self._by_owner: dict[int, Extent] = {}
        self.peak_used = 0
        self._used = 0

    # -- bookkeeping --------------------------------------------------------
    def _coalesce(self) -> None:
        out: list[Extent] = []
        for e in self.extents:
            if out and out[-1].free and e.free:
                prev = out[-1]
                prev.size += e.size
                prev.last_writers |= e.last_writers
                prev.last_direct |= e.last_direct
                prev.last_use = max(prev.last_use, e.last_use)
            else:
                out.append(e)
        self.extents = out

    def owner_extent(self, mid: int) -> Extent:
        return self._by_owner[mid]

    def used(self) -> int:
        return self._used

    def pin(self, mid: int) -> None:
        self._by_owner[mid].pinned += 1

    def unpin(self, mid: int) -> None:
        e = self._by_owner[mid]
        if e.pinned <= 0:
            raise AssertionError(f"unbalanced unpin of {mid}")
        e.pinned -= 1

    def set_owner(self, old_mid: int, new_mid: int) -> None:
        """Transfer ownership (e.g. streaming-reduce JOIN takes over)."""
        e = self._by_owner.pop(old_mid)
        e.owner = new_mid
        self._by_owner[new_mid] = e

    # -- free ---------------------------------------------------------------
    def free(self, mid: int, seq: int, *, wrote: bool = True) -> None:
        """Return an extent. ``wrote=False`` releases a reservation that never
        produced data: the bytes' true last writers are the carried-forward
        ones, not the (cancelled) owner."""
        e = self._by_owner.pop(mid)
        if e.pinned:
            raise AssertionError(f"freeing pinned extent of {mid}")
        e.owner = None
        e.last_writers = {mid} if wrote else set(e.carried_writers)
        e.last_direct = set() if wrote else set(e.carried_direct)
        e.carried_writers = set()
        e.carried_direct = set()
        e.last_use = seq
        self._used -= e.size
        self._coalesce()

    # -- allocation from free space only (simMalloc) -------------------------
    def place_free(self, size: int) -> PlacementDecision | None:
        """Place in free space only (may span several adjacent free extents).
        §C policy: prefer the window whose last use is furthest in the past."""
        if size > self.capacity:
            return None
        best: tuple[tuple, int] | None = None  # (score, start extent index)
        n = len(self.extents)
        i = 0
        while i < n:
            if not self.extents[i].free:
                i += 1
                continue
            # maximal free run starting at i
            run = 0
            last_use = -1
            j = i
            while j < n and self.extents[j].free:
                run += self.extents[j].size
                j += 1
            if run >= size:
                # recency of the covered window only
                cov = 0
                k = i
                while cov < size:
                    last_use = max(last_use, self.extents[k].last_use)
                    cov += self.extents[k].size
                    k += 1
                score = (last_use, self.extents[i].offset)
                if best is None or score < best[0]:
                    best = (score, i)
            i = j
        if best is None:
            return None
        return self._carve(self.extents[best[1]].offset, size)

    # -- allocation with eviction (simMallocOffld) ----------------------------
    def place_evict(
        self,
        size: int,
        next_use: Callable[[int], float],
        *,
        allow_cancel: bool = False,
        victim_policy: str = "belady",
        rng: random.Random | None = None,
    ) -> EvictionDecision | None:
        """Pick a window ``[a, a+size)`` minimizing eviction damage.

        Every extent overlapping the window must be free, or owned by an
        executed+unpinned vertex (→ offload victim), or — when
        ``allow_cancel`` — an unexecuted+unpinned reservation (→ cancel).
        """
        if size > self.capacity:
            return None
        n = len(self.extents)
        best: tuple[tuple, int] | None = None  # (score key, anchor index)
        for i in range(n):
            a = self.extents[i].offset
            if a + size > self.capacity:
                break
            victims, cancels, ok = self._window_victims(i, a, size, allow_cancel)
            if not ok:
                continue
            if victim_policy == "belady":
                # maximize the minimum next use over evicted tensors (§C)
                mn = min((next_use(e.owner) for e in victims + cancels),
                         default=INF)
                score = (-mn,)
            elif victim_policy == "lru":
                mx = max((e.last_use for e in victims + cancels), default=-1)
                score = (mx,)
            elif victim_policy == "random":
                score = ((rng or random).random(),)
            else:
                raise ValueError(f"unknown victim policy {victim_policy!r}")
            evict_bytes = sum(e.size for e in victims + cancels)
            key = (score, len(cancels), evict_bytes, a)
            if best is None or key < best[0]:
                best = (key, i)
        if best is None:
            return None
        i = best[1]
        a = self.extents[i].offset
        victims, cancels, _ = self._window_victims(i, a, size, allow_cancel)
        victim_mids = [e.owner for e in victims]
        cancel_mids = [e.owner for e in cancels]
        return EvictionDecision(a, size, set(), victim_mids, cancel_mids)

    def _window_victims(self, i: int, a: int, size: int, allow_cancel: bool):
        victims: list[Extent] = []
        cancels: list[Extent] = []
        for j in range(i, len(self.extents)):
            e = self.extents[j]
            if e.offset >= a + size:
                break
            if e.free:
                continue
            if e.pinned:
                return [], [], False
            if e.owner in self._executed_set:
                victims.append(e)
            elif allow_cancel:
                cancels.append(e)
            else:
                return [], [], False
        return victims, cancels, True

    # The builder tells the arena which owners are executed (have data) so
    # eviction can distinguish offload victims from cancellable reservations.
    _executed_set: set[int] = set()

    def bind_executed_set(self, executed: set[int]) -> None:
        self._executed_set = executed

    # -- carving --------------------------------------------------------------
    def evict_and_carve(self, dec: EvictionDecision, seq: int) -> PlacementDecision:
        """Free whole victim/cancelled extents, then carve the window."""
        for mid in dec.victims:
            self.free(mid, seq, wrote=True)
        for mid in dec.cancelled:
            self.free(mid, seq, wrote=False)
        return self._carve(dec.offset, dec.size)

    def _carve(self, offset: int, size: int) -> PlacementDecision:
        """Carve ``[offset, offset+size)`` out of free extents (must be free)."""
        writers: set[int] = set()
        direct: set[int] = set()
        i = 0
        while i < len(self.extents):
            e = self.extents[i]
            if e.end <= offset:
                i += 1
                continue
            if e.offset >= offset + size:
                break
            if not e.free:
                raise AssertionError("carve over non-free extent")
            writers |= e.last_writers
            direct |= e.last_direct
            # split head
            if e.offset < offset:
                head = Extent(e.offset, offset - e.offset, None,
                              set(e.last_writers), e.last_use,
                              last_direct=set(e.last_direct))
                e.offset, e.size = offset, e.end - offset
                self.extents.insert(i, head)
                i += 1
                continue
            # split tail
            if e.end > offset + size:
                tail = Extent(offset + size, e.end - (offset + size), None,
                              set(e.last_writers), e.last_use,
                              last_direct=set(e.last_direct))
                e.size = offset + size - e.offset
                self.extents.insert(i + 1, tail)
            # consume e
            i += 1
        # merge the covered free extents into a single placeholder
        covered = [e for e in self.extents
                   if e.offset >= offset and e.end <= offset + size]
        assert covered and covered[0].offset == offset \
            and covered[-1].end == offset + size, "carve window not covered"
        keep = covered[0]
        keep.size = size
        keep.last_writers = set()
        keep.last_direct = set()
        for e in covered[1:]:
            self.extents.remove(e)
        return PlacementDecision(offset, size, writers, direct)

    def commit(self, dec: PlacementDecision, mid: int) -> Extent:
        for e in self.extents:
            if e.offset == dec.offset and e.size == dec.size and e.free:
                e.owner = mid
                e.pinned = 0
                e.carried_writers = set(dec.prev_writers)
                e.carried_direct = set(dec.direct_deps)
                self._by_owner[mid] = e
                self._used += e.size
                self.peak_used = max(self.peak_used, self._used)
                return e
        raise AssertionError("commit target extent not found")


# --------------------------------------------------------------------------
# the host tier (beyond-paper: bounded CPU RAM with disk spill, DESIGN.md §10)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostEntry:
    """One logical host copy: the payload of an OFFLOAD (re-staged by LOADs
    after disk spills). ``producer`` is the vertex whose completion makes
    the current host bytes live (the OFFLOAD, or the latest LOAD);
    ``readers`` are the emitted vertices that read those bytes (RELOADs and
    SPILLs), which any later spill of the extent must order after."""

    key: int                      # host-store key = the OFFLOAD vertex mid
    tid: int
    size: int                     # units (same size_fn units as devices)
    nbytes: int
    producer: int
    resident: bool = True         # bytes currently in host RAM
    spill_src: int | None = None  # SPILL vertex owning the immutable disk copy
    readers: set[int] = dataclasses.field(default_factory=set)
    # LOAD vertices that read the disk blob: a drop of the blob (freeing
    # its disk-tier units) must order after every one of them
    disk_readers: set[int] = dataclasses.field(default_factory=set)
    # readers of *retired* residencies (accumulated when a spill or a
    # restage resets ``readers``) and the most recent SPILL: a final drop
    # releases every copy of the bytes, so it must order after anything
    # that ever read them on any tier — per-residency deps alone leave a
    # racy window for readers of earlier residencies
    all_readers: set[int] = dataclasses.field(default_factory=set)
    last_spill: int | None = None


class HostPlan:
    """Compile-time model of the bounded host tier.

    ``capacity=None`` models the unbounded host store (the paper's implicit
    assumption): nothing is tracked beyond the peak-occupancy counter and no
    SPILL/LOAD vertices are ever requested, so existing plans are unchanged.

    With a capacity, host copies become arena tenants. :meth:`admit` carves
    space for a new copy, spilling Belady-chosen victims through the
    builder-supplied callback; the returned mids are ordering obligations
    (MEM deps) the admitted producer must wait on — exactly the
    safe-overwrite discipline of the device arenas, one tier down."""

    def __init__(self, capacity: int | None,
                 next_use: Callable[[HostEntry], float]) -> None:
        self.capacity = capacity
        self.arena = Arena(-1, capacity) if capacity is not None else None
        self.entries: dict[int, HostEntry] = {}
        self.next_use = next_use
        self._occ = 0                 # unbounded-mode occupancy (units)
        self._peak = 0
        # ground-truth residency intervals for the certifier's budget pass
        # (DESIGN.md §13): [key, admit_mid, release_mid|None, size] per
        # host-arena tenancy, in admission order. The certifier recovers
        # the same intervals from the graph alone; tests cross-check.
        self.residency_log: list[list[Any]] = []
        self._open_res: dict[int, int] = {}      # key -> residency_log index

    @property
    def bounded(self) -> bool:
        return self.arena is not None

    @property
    def peak_units(self) -> int:
        return self.arena.peak_used if self.bounded else self._peak

    @property
    def used_units(self) -> int:
        """Current host-tier occupancy (units)."""
        return self.arena.used() if self.bounded else self._occ

    def note_unbounded(self, size: int) -> None:
        """Unbounded mode: track occupancy so callers can size real budgets
        (e.g. ``host_capacity = fraction * unbounded_peak``)."""
        self._occ += size
        self._peak = max(self._peak, self._occ)

    # ---------------------------------------------------------- admission
    def admit(self, key: int, tid: int, size: int, nbytes: int,
              producer: int, seq: int,
              spill_cb: Callable[[HostEntry], int],
              exclude: frozenset = frozenset(),
              allow_spill: bool = True) -> set[int] | None:
        """Place ``producer``'s host copy; returns the MEM-dep mids it must
        order after, or ``None`` when the resident working set cannot be
        spilled down far enough (host OOM). ``spill_cb(entry)`` must emit
        the SPILL vertex for a victim and return its mid.
        ``allow_spill=False`` admits into genuinely free space only (the
        prefetch path: an opportunistic restage must never force other
        copies out) — ``None`` then just means "no room now"."""
        if not self.bounded:
            self.note_unbounded(size)
            return set()
        if size > self.arena.capacity:
            return None
        while True:
            dec = self.arena.place_free(size)
            if dec is not None:
                break
            if not allow_spill:
                return None
            victim = self._pick_victim(exclude)
            if victim is None:
                return None
            self.spilled(victim, spill_cb(victim), seq)
        deps = set(dec.prev_writers) | set(dec.direct_deps)
        self.arena.commit(dec, producer)
        e = self.entries.get(key)
        if e is None:
            self.entries[key] = HostEntry(key, tid, size, nbytes, producer)
        else:                          # re-staged by a LOAD
            e.producer = producer
            e.resident = True
            e.all_readers |= e.readers
            e.readers = set()
        self._open_res[key] = len(self.residency_log)
        self.residency_log.append([key, producer, None, size])
        return deps

    def _pick_victim(self, exclude: frozenset) -> HostEntry | None:
        """Belady over the schedule: spill the resident copy whose next
        known use is furthest; among never-needed copies prefer the largest
        (fewest spill ops per freed unit)."""
        best: tuple[tuple, HostEntry] | None = None
        for e in self.entries.values():
            if not e.resident or e.key in exclude:
                continue
            score = (-self.next_use(e), -e.size, e.key)
            if best is None or score < best[0]:
                best = (score, e)
        return best[1] if best else None

    # --------------------------------------------------------- bookkeeping
    def spilled(self, e: HostEntry, smid: int, seq: int) -> None:
        """Record that ``smid`` (a SPILL vertex) evicted ``e`` from the host
        arena: the freed extent's last writer becomes the spill itself, so
        the next tenant of those units orders after the eviction completes."""
        self.arena.set_owner(e.producer, smid)
        self.arena.free(smid, seq)
        e.resident = False
        e.all_readers |= e.readers
        e.readers = set()
        e.last_spill = smid
        if e.spill_src is None:
            e.spill_src = smid         # first spill owns the disk copy
        idx = self._open_res.pop(e.key, None)
        if idx is not None:
            self.residency_log[idx][2] = smid

    def dropped(self, e: HostEntry, dmid: int, seq: int) -> None:
        """Record a dead host copy's release (drop vertex ``dmid``)."""
        self.arena.set_owner(e.producer, dmid)
        self.arena.free(dmid, seq)
        del self.entries[e.key]
        idx = self._open_res.pop(e.key, None)
        if idx is not None:
            self.residency_log[idx][2] = dmid

    def forget(self, key: int) -> None:
        """Delete a dead, non-resident entry (its disk blob may linger)."""
        self.entries.pop(key, None)


# --------------------------------------------------------------------------
# cross-tier prefetch (beyond-paper: DESIGN.md §11)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrefetchRecord:
    """One reactive disk→host LOAD observed in pass 1 of the build.

    Positions are *execution windows*: window ``w`` spans from the
    completion of the ``w-1``-th executed task to the completion of the
    ``w``-th. ``spill_pos`` is the window in which the entry's first SPILL
    was emitted (the disk blob exists from then on); ``reload_pos`` the
    window in which pass 1 emitted the reactive LOAD (while executing the
    consumer)."""

    tid: int
    size: int                     # units the restaged copy occupies
    nbytes: int                   # real bytes the disk hop moves
    spill_pos: int
    reload_pos: int


class PrefetchPlan:
    """Backward walk over a completed build's host-occupancy profile.

    ``occ_at[w]`` is the maximum host-tier occupancy (units) observed
    during execution window ``w`` of pass 1. For each reactive LOAD the
    plan scans backward from its consumer: hoisting the LOAD to the
    boundary after window ``p`` keeps the restaged bytes resident through
    windows ``p+1 .. reload_pos-1``, so the earliest feasible ``p`` is the
    smallest one (≥ ``spill_pos``, within ``prefetch_distance``) for which
    every one of those windows still fits under ``capacity``. Committed
    hoists are charged back into the profile, so overlapping prefetches
    remain *jointly* feasible — the plan never schedules a restage that
    would force other host copies out (pass 2 additionally enforces this
    structurally: prefetch admissions use free space only).

    The result is a hint map ``{window p -> [tids to restage there]}``
    consumed by pass 2 of the builder, plus the ``stall_bytes_hidden``
    counter: disk bytes whose transfer was moved off the consumers'
    critical path."""

    def __init__(self, capacity: int, occ_at: list[int],
                 distance: int) -> None:
        self.capacity = capacity
        self.occ = list(occ_at)
        self.distance = max(int(distance), 0)
        self.hints: dict[int, list[int]] = {}
        self.n_hoisted = 0
        self.stall_bytes_hidden = 0

    def hoist(self, rec: PrefetchRecord) -> int | None:
        """Earliest feasible emission window for ``rec``; commits the hoist
        (charging the occupancy profile) and returns the window, or
        ``None`` when no earlier point fits."""
        lo = max(rec.spill_pos, rec.reload_pos - self.distance, 0)
        p = rec.reload_pos
        q = rec.reload_pos - 1
        while q >= lo:
            # window q+1 .. reload_pos-1 must absorb the restaged bytes;
            # moving the boundary one window earlier adds window q+1's
            # constraint (the boundary after q starts window q+1)
            if (q + 1 < rec.reload_pos
                    and self.occ[q + 1] + rec.size > self.capacity):
                break
            p = q
            q -= 1
        if p >= rec.reload_pos:
            return None
        for w in range(p + 1, rec.reload_pos):
            self.occ[w] += rec.size
        self.hints.setdefault(p, []).append(rec.tid)
        self.n_hoisted += 1
        self.stall_bytes_hidden += rec.nbytes
        return p

    def compute(self, records: Iterable[PrefetchRecord]
                ) -> dict[int, list[int]]:
        """Hoist every record (schedule order) and return the hint map."""
        for rec in sorted(records, key=lambda r: (r.reload_pos, r.tid)):
            self.hoist(rec)
        return self.hints
