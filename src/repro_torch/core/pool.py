"""Pool-level host-RAM arbitration: one pinned budget, many consumers.

TURNIP's premise — "inexpensive CPU RAM is used to increase the amount of
storage available" — made every consumer treat host RAM as *its* budget:
the compiler charged ``BuildConfig.host_capacity``, the serving engine
charged ``ServeConfig.host_kv_bytes``, and nothing arbitrated between them
even though ``Engine(host=...)`` can share a runtime's store. NEO
(PAPERS.md) shows why that matters: online serving hits the host ceiling
first, exactly when offload traffic from a co-resident MEMGRAPH plan is
also peaking. This module owns the *pool*:

* :class:`HostPool` — the single pinned budget. Consumers hold named
  :class:`Lease`\\ s (``memgraph``, ``kv``, ``prefetch``, ...) and a
  pluggable :class:`ArbitrationPolicy` splits the capacity between them.
* :class:`Lease` — one consumer's share. Two charge disciplines, one per
  consumer style (documented per call-site; never mix them on one lease):

  - **reserving** (the serving engine): :meth:`Lease.try_charge` *before*
    moving bytes; a refusal defers the transfer (and records pressure so
    the consumer's own spill stream makes room). Bytes never land
    uncharged, so the pool bound holds by construction.
  - **occupancy** (a plan-driven :class:`~repro_torch.core.stores.TieredStore`):
    the store mirrors its ``resident_bytes`` deltas via
    :meth:`Lease.account`. The compiled plan's feasibility check already
    bounded the peak by the lease's floor (``min_bytes``), so accounting
    is observational — the plan cannot overflow a floor it compiled under.

* Arbitration policies (:func:`get_arbitration_policy`):

  - ``static`` — floors, then the remainder split by ``weight``; grants
    never react to load (the predictable baseline);
  - ``demand`` — floors, then the remainder follows current demand
    (``used`` + the latest request), so an idle consumer's slack flows to
    the busy one;
  - ``priority`` — strict ranking: higher-priority leases are granted
    their demand first (resumable KV blocks outrank far-future MEMGRAPH
    reloads, which are cheap to re-stage), lower ones are squeezed toward
    their floors.

* **Revocation.** When a rebalance shrinks a lease's grant below its
  ``used`` bytes, the pool fires the lease's ``on_revoke(deficit)``
  callback — *outside* the pool lock, and the callback must be a cheap
  pressure signal (set a flag, bump a counter), never a blocking inline
  write: the consumer drains the deficit through its own LRU spill path
  on its own disk stream. Floors are inviolable — ``min_bytes`` is the
  share a consumer compiled or sized against, and no policy may revoke
  below it — so revocation changes *timing* (when spills happen), never
  results.

Counters: every lease tracks ``used``/``peak``/``refusals``/
``revoked_bytes``; the pool tracks ``used_bytes``/``peak_bytes``/
``revocations``. The shared-pool benchmark asserts the headline invariant
on these: combined occupancy never exceeds the pool budget, and outputs
are byte-identical to isolated per-consumer pools.
"""
from __future__ import annotations

import contextlib
import threading

from . import lockcheck
from .liveness import LivenessModelError
from typing import Callable, Iterator

__all__ = ["HostPool", "Lease", "LeaseRefusal", "ArbitrationPolicy",
           "ARBITRATION_POLICY_NAMES", "get_arbitration_policy"]

# thread-local marker: the lease whose revocation drain the current thread
# is running (HostPool.draining; liveness assumption A2, DESIGN.md §14)
_drain_tls = threading.local()


class LeaseRefusal(RuntimeError):
    """A mandatory charge could not fit the lease's arbitrated share."""


class Lease:
    """One consumer's share of a :class:`HostPool`.

    All mutation goes through the owning pool (single lock, single
    source of truth); the attributes here are plain reads — fine for
    scheduling heuristics and stats, exact under the pool lock."""

    def __init__(self, pool: "HostPool", name: str, *, min_bytes: int = 0,
                 weight: float = 1.0, priority: int = 0,
                 on_revoke: Callable[[int], None] | None = None,
                 drains_via: tuple[str, ...] = ()) -> None:
        self.pool = pool
        self.name = name
        self.min_bytes = int(min_bytes)
        self.weight = float(weight)
        self.priority = int(priority)
        self.on_revoke = on_revoke
        # leases this one's revocation drain may charge while draining
        # (liveness assumption A2): a drain that blocks on an undeclared
        # lease is a blocking edge outside the static model
        self.drains_via: tuple[str, ...] = tuple(drains_via)
        # guaranteed share the liveness certifier proved the plan's
        # occupancy stays within (assumption A1); None = not certified
        self.certified_floor: int | None = None
        self.grant = 0            # current arbitrated share (bytes)
        self.used = 0             # bytes charged / resident against us
        self.peak = 0             # high-water mark of `used`
        self.demand = 0           # current want: used + latest request
        self.refusals = 0         # try_charge calls that did not fit
        self.pressure = 0         # deficit of deferred urgent charges
        self.revoked_bytes = 0    # cumulative grant shrinkage below `used`
        self.closed = False

    # thin forwarding surface: consumers hold the lease, not the pool
    def try_charge(self, n: int, *, urgent: bool = True) -> bool:
        return self.pool.try_charge(self, n, urgent=urgent)

    def charge(self, n: int) -> None:
        if not self.try_charge(n):
            raise LeaseRefusal(
                f"lease {self.name!r}: {n} B does not fit share "
                f"{self.grant} B ({self.used} B used, pool "
                f"{self.pool.capacity} B)")

    def release(self, n: int) -> None:
        self.pool.release(self, n)

    def account(self, delta: int) -> None:
        self.pool.account(self, delta)

    @property
    def headroom(self) -> int:
        """Free bytes under the current grant (scheduling heuristic: the
        serving prefetcher sizes its opportunistic staging by this)."""
        return max(0, self.grant - self.used)

    @property
    def overage(self) -> int:
        """Bytes held past the current grant (after a revocation): what
        the consumer's own spill path should drain."""
        return max(0, self.used - self.grant)

    def close(self) -> None:
        self.pool.close_lease(self)


# --------------------------------------------------------------------------
# arbitration policies
# --------------------------------------------------------------------------
class ArbitrationPolicy:
    """Split the pool capacity into per-lease grants.

    ``split`` runs under the pool lock and must be pure: floors
    (``min_bytes``) are already guaranteed feasible by
    :meth:`HostPool.lease`; the returned grants must sum to at most
    ``capacity`` and honor every floor."""

    name = "base"

    def split(self, capacity: int, leases: list[Lease]) -> dict[str, int]:
        raise NotImplementedError

    @staticmethod
    def _floors(capacity: int, leases: list[Lease]) -> tuple[dict[str, int], int]:
        grants = {l.name: l.min_bytes for l in leases}
        return grants, capacity - sum(grants.values())


class StaticSplitPolicy(ArbitrationPolicy):
    """Floors, then the remainder by ``weight`` — load-independent."""

    name = "static"

    def split(self, capacity: int, leases: list[Lease]) -> dict[str, int]:
        grants, rest = self._floors(capacity, leases)
        total_w = sum(l.weight for l in leases) or 1.0
        for l in leases:
            grants[l.name] += int(rest * l.weight / total_w)
        return grants


class DemandProportionalPolicy(ArbitrationPolicy):
    """Floors, then the remainder follows current demand above the floor;
    with no demand anywhere, fall back to the static weights."""

    name = "demand"

    def split(self, capacity: int, leases: list[Lease]) -> dict[str, int]:
        grants, rest = self._floors(capacity, leases)
        wants = {l.name: max(max(l.demand, l.used) - l.min_bytes, 0)
                 for l in leases}
        total = sum(wants.values())
        if total <= 0:
            total_w = sum(l.weight for l in leases) or 1.0
            for l in leases:
                grants[l.name] += int(rest * l.weight / total_w)
            return grants
        for l in leases:
            grants[l.name] += min(int(rest * wants[l.name] / total),
                                  wants[l.name])
        # demand under-consumes the pool when wants < rest: top the
        # leftovers back up by weight so capacity is never stranded
        leftover = capacity - sum(grants.values())
        if leftover > 0:
            total_w = sum(l.weight for l in leases) or 1.0
            for l in leases:
                grants[l.name] += int(leftover * l.weight / total_w)
        return grants


class PriorityPolicy(ArbitrationPolicy):
    """Strict ranking: grant each lease its demand in priority order
    (ties broken by weight, then name, for determinism); lower-priority
    leases are squeezed toward their floors when a higher one's demand
    grows — resumable KV blocks outrank far-future MEMGRAPH reloads."""

    name = "priority"

    def split(self, capacity: int, leases: list[Lease]) -> dict[str, int]:
        grants, rest = self._floors(capacity, leases)
        order = sorted(leases, key=lambda l: (-l.priority, -l.weight, l.name))
        for l in order:
            want = max(max(l.demand, l.used) - l.min_bytes, 0)
            give = min(want, rest)
            grants[l.name] += give
            rest -= give
        if rest > 0 and order:
            grants[order[0].name] += rest     # slack parks on the top rank
        return grants


ARBITRATION_POLICY_NAMES = ("static", "demand", "priority")
_POLICIES = {p.name: p for p in (StaticSplitPolicy, DemandProportionalPolicy,
                                 PriorityPolicy)}


def get_arbitration_policy(policy: str | ArbitrationPolicy) -> ArbitrationPolicy:
    if isinstance(policy, ArbitrationPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown arbitration policy {policy!r}; expected "
                         f"one of {ARBITRATION_POLICY_NAMES}") from None


# --------------------------------------------------------------------------
# the pool
# --------------------------------------------------------------------------
class HostPool:
    """One pinned host-RAM budget arbitrated across named leases.

    The pool lock is a *leaf* lock: consumers call in while holding their
    own locks (store lock, engine lock), and the pool never calls consumer
    code under it — revocation callbacks are collected inside the lock and
    fired after it is released."""

    def __init__(self, capacity: int,
                 policy: str | ArbitrationPolicy = "static") -> None:
        if capacity <= 0:
            raise ValueError("pool capacity must be positive")
        self.capacity = int(capacity)
        self.policy = get_arbitration_policy(policy)
        self._leases: dict[str, Lease] = {}
        self._lock = lockcheck.make_lock("HostPool")
        self.used_bytes = 0
        self.peak_bytes = 0
        self.revocations = 0

    # ------------------------------------------------------------- leases
    def lease(self, name: str, *, min_bytes: int = 0, weight: float = 1.0,
              priority: int = 0,
              on_revoke: Callable[[int], None] | None = None,
              drains_via: tuple[str, ...] = ()) -> Lease:
        """Get-or-create the lease called ``name``. Floors must be jointly
        feasible: the sum of every lease's ``min_bytes`` can never exceed
        the pool — an infeasible floor is refused at lease time, not
        discovered as a silent overcommit under load."""
        with self._lock:
            l = self._leases.get(name)
            if l is not None:
                if on_revoke is not None and l.on_revoke is None:
                    l.on_revoke = on_revoke
                if drains_via and not l.drains_via:
                    l.drains_via = tuple(drains_via)
                return l
            floor_sum = sum(x.min_bytes for x in self._leases.values())
            if floor_sum + min_bytes > self.capacity:
                raise ValueError(
                    f"lease {name!r} floor of {min_bytes} B is infeasible: "
                    f"{floor_sum} B of floors already promised out of "
                    f"{self.capacity} B")
            l = Lease(self, name, min_bytes=min_bytes, weight=weight,
                      priority=priority, on_revoke=on_revoke,
                      drains_via=drains_via)
            self._leases[name] = l
            fire = self._rebalance_locked()
        self._fire(fire)
        return l

    def close_lease(self, l: Lease) -> None:
        """Retire a lease: its bytes must already be drained (or the
        caller accepts losing track of them); its share returns to the
        pool."""
        with self._lock:
            if self._leases.get(l.name) is not l:
                return
            del self._leases[l.name]
            self.used_bytes -= l.used
            l.used = 0
            l.closed = True
            fire = self._rebalance_locked()
        self._fire(fire)

    def leases(self) -> list[Lease]:
        with self._lock:
            return list(self._leases.values())

    @contextlib.contextmanager
    def draining(self, l: Lease) -> Iterator[None]:
        """Mark the current thread as running ``l``'s revocation drain
        (liveness assumption A2, DESIGN.md §14). While active, any
        :meth:`try_charge` against this pool must target ``l`` itself or
        a lease named in ``l.drains_via`` — the edges the static blocking
        model knows about. A charge against any other lease is a blocking
        edge the certifier never saw, so it is reported as certifier
        unsoundness rather than allowed to deadlock silently. Releases
        are always permitted: draining *is* releasing."""
        prev = getattr(_drain_tls, "lease", None)
        _drain_tls.lease = l
        try:
            yield
        finally:
            _drain_tls.lease = prev

    # ------------------------------------------------------------ charges
    def try_charge(self, l: Lease, n: int, *, urgent: bool = True) -> bool:
        """Reserve ``n`` bytes against ``l`` *before* the bytes move.

        Records demand, rebalances (the demand/priority policies may grow
        the grant — possibly revoking someone else's slack), and either
        admits the charge or refuses it. An urgent refusal records the
        deficit as ``pressure`` so the consumer's spill scheduler knows
        how many bytes to free; an opportunistic one (``urgent=False``,
        e.g. predictive prefetch) only counts the refusal."""
        n = int(n)
        if n < 0:
            raise ValueError("charge must be non-negative")
        drain = getattr(_drain_tls, "lease", None)
        if (drain is not None and drain.pool is self
                and l.name != drain.name
                and l.name not in drain.drains_via):
            raise LivenessModelError(
                f"revocation drain of lease {drain.name!r} charged lease "
                f"{l.name!r}, which is not in its declared drains_via "
                f"{drain.drains_via!r}: a blocking edge outside the static "
                f"model — the liveness certifier is unsound for this "
                f"configuration (assumption A2, DESIGN.md §14)")
        with self._lock:
            l.demand = l.used + n
            fire: list[tuple[Callable[[int], None], int]] = []
            if l.used + n > l.grant:
                fire = self._rebalance_locked()
            # the grant admits the charge AND the pool itself has room:
            # a freshly revoked lease still *holds* its overage until its
            # own spill stream drains it, and granting those bytes away
            # before they are physically free would burst the pool bound
            if (l.used + n <= l.grant
                    and self.used_bytes + n <= self.capacity):
                self._apply_locked(l, n)
                l.pressure = 0
                ok = True
            else:
                l.refusals += 1
                if urgent:
                    l.pressure = max(l.pressure, l.used + n - l.grant,
                                     self.used_bytes + n - self.capacity)
                ok = False
        self._fire(fire)
        return ok

    def release(self, l: Lease, n: int) -> None:
        with self._lock:
            self._apply_locked(l, -int(n))
            l.demand = l.used
            fire = self._rebalance_locked()
        self._fire(fire)

    def account(self, l: Lease, delta: int) -> None:
        """Occupancy accounting (the :class:`TieredStore` discipline):
        mirror a resident-bytes delta into the lease unconditionally.
        Growth past the grant is possible only for consumers whose bound
        is enforced elsewhere (a compiled plan's floor); the rebalance
        still runs so other leases see the pressure immediately."""
        with self._lock:
            self._apply_locked(l, int(delta))
            l.demand = l.used
            used, floor = l.used, l.certified_floor
            fire = self._rebalance_locked()
        self._fire(fire)
        if floor is not None and used > floor:
            raise LivenessModelError(
                f"lease {l.name!r} occupancy {used} B exceeded the "
                f"certified guaranteed share of {floor} B the liveness "
                f"proof assumed (assumption A1, DESIGN.md §14): the "
                f"certifier is unsound or the runtime diverged from the "
                f"compiled plan")

    def transfer(self, src: Lease, dst: Lease, n: int) -> None:
        """Move ``n`` charged bytes between leases (no pool-level change):
        e.g. a prefetch-staged KV block becomes a resuming request's
        resident block. Forced — the bytes are already in host RAM, so
        refusing would strand them; ``dst`` may transiently exceed its
        grant and its own spill path drains the overage."""
        with self._lock:
            self._apply_locked(src, -int(n))
            self._apply_locked(dst, int(n))
            src.demand, dst.demand = src.used, dst.used
            fire = self._rebalance_locked()
        self._fire(fire)

    # ------------------------------------------------------------ internals
    def _apply_locked(self, l: Lease, delta: int) -> None:
        l.used += delta
        if l.used < 0:          # release/account drift is a consumer bug;
            l.used = 0          # clamp so one bug cannot corrupt the pool
        l.peak = max(l.peak, l.used)
        self.used_bytes = sum(x.used for x in self._leases.values())
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def _rebalance_locked(self) -> list[tuple[Callable[[int], None], int]]:
        """Recompute grants; returns (callback, deficit) pairs to fire
        *after* the lock is released."""
        leases = list(self._leases.values())
        if not leases:
            return []
        grants = self.policy.split(self.capacity, leases)
        assert sum(grants.values()) <= self.capacity, \
            f"policy {self.policy.name!r} overcommitted the pool"
        fire: list[tuple[Callable[[int], None], int]] = []
        for l in leases:
            g = grants[l.name]
            assert g >= l.min_bytes, \
                f"policy {self.policy.name!r} violated {l.name!r}'s floor"
            shrunk = g < l.grant
            l.grant = g
            deficit = l.used - g
            if shrunk and deficit > 0:
                self.revocations += 1
                l.revoked_bytes += deficit
                if l.on_revoke is not None:
                    fire.append((l.on_revoke, deficit))
        return fire

    @staticmethod
    def _fire(fire: list[tuple[Callable[[int], None], int]]) -> None:
        for cb, deficit in fire:
            cb(deficit)

    @property
    def drained(self) -> bool:
        """True when no lease holds any bytes — the post-teardown invariant
        the fleet chaos harness asserts per surviving replica: a drained
        pool proves every migrated/finished request's reservations were
        released, not leaked."""
        with self._lock:
            return all(l.used == 0 for l in self._leases.values())

    def snapshot(self) -> dict:
        """Counters for benchmarks/monitoring: one dict per lease plus the
        pool totals."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "used_bytes": self.used_bytes,
                "peak_bytes": self.peak_bytes,
                "revocations": self.revocations,
                "leases": {
                    n: {"grant": l.grant, "used": l.used, "peak": l.peak,
                        "min_bytes": l.min_bytes, "refusals": l.refusals,
                        "revoked_bytes": l.revoked_bytes}
                    for n, l in self._leases.items()},
            }
