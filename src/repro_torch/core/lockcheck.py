"""Debug-mode lock-order sanitizer (the dynamic complement to the static
plan certifier, DESIGN.md §13).

The runtime's locking discipline is documented but was only enforced by
review: ``HostPool._lock`` is a leaf (consumers charge/release while
holding their own store locks; arbitration callbacks fire outside it),
``DiskStore._lock`` is a leaf under ``TieredStore``'s store lock, and
the serving engine's ``_revoke_lock`` is a leaf under the engine lock.
This module turns the discipline into an assertion: every lock the
inventory cares about is a :class:`SanitizedLock`; while enabled (tests
only — one branch on a module flag otherwise), each acquisition records
``held-class → acquired-class`` edges with the acquiring thread, and
:func:`assert_acyclic` fails with the concrete cycle and example threads
if two code paths ever take the same pair of lock classes in opposite
orders — a deadlock that needs exact interleaving to bite, caught on any
schedule.

``SanitizedLock`` satisfies the ``threading.Lock`` protocol including
what ``threading.Condition`` needs, so instrumented locks keep backing
condition variables.

**Wait-awareness.** ``Condition.wait()`` *releases* the lock while
sleeping and reacquires it afterwards. Recorded naively, that reacquire
looks like a fresh acquisition: any lock still held below the waited-on
one on the thread's stack would grow a ``inner → outer`` edge — the
exact inverse of the real ``outer → inner`` nesting of the same single
code path, closing a false cycle that cannot deadlock (the waiter gave
the outer lock up; nothing is held-and-wanted in both directions).
``SanitizedLock`` therefore implements the private hooks
``threading.Condition`` probes for (``_release_save`` /
``_acquire_restore`` / ``_is_owned``): the wait-release remembers the
lock's position on the held stack, and the post-notify reacquire
reinserts it *at that position without recording any edge* — a
resumption of an already-audited hold, not a new ordering decision.
"""
from __future__ import annotations

import threading
from typing import Any

__all__ = ["SanitizedLock", "LockOrderError", "make_lock", "enable",
           "disable", "reset", "enabled", "edges", "assert_acyclic"]


class LockOrderError(AssertionError):
    """Two lock classes were acquired in both orders (deadlock hazard)."""


_enabled = False
_reg_lock = threading.Lock()          # guards the edge registry (leaf)
_edges: dict[str, set[str]] = {}      # held class -> then-acquired class
_examples: dict[tuple[str, str], str] = {}   # edge -> first thread seen
_tls = threading.local()


def enable() -> None:
    """Start recording acquisition-order edges (test fixtures)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget all recorded edges (per-test isolation)."""
    with _reg_lock:
        _edges.clear()
        _examples.clear()


def enabled() -> bool:
    return _enabled


def edges() -> dict[str, set[str]]:
    """Snapshot of the acquisition graph (held class -> acquired class)."""
    with _reg_lock:
        return {k: set(v) for k, v in _edges.items()}


def _held_stack() -> list[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _record_acquire(cls: str) -> None:
    stack = _held_stack()
    if stack:
        thread = threading.current_thread().name
        with _reg_lock:
            for held in stack:
                if held != cls:
                    _edges.setdefault(held, set()).add(cls)
                    _examples.setdefault((held, cls), thread)
    stack.append(cls)


def _record_release(cls: str) -> int:
    stack = _held_stack()
    # releases need not be LIFO (condition waits, hand-over-hand): drop
    # the most recent matching hold. Returns the stack position the hold
    # occupied so a wait-release can restore it exactly.
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == cls:
            del stack[i]
            return i
    return len(stack)


def _record_wait_reacquire(cls: str, pos: int) -> None:
    """Reinsert a wait-released hold at its saved stack position WITHOUT
    recording edges: the thread never chose a new acquisition order — it
    resumed a hold that was already audited when first taken."""
    stack = _held_stack()
    stack.insert(min(pos, len(stack)), cls)


class SanitizedLock:
    """A ``threading.Lock`` that reports its acquisition order while the
    sanitizer is enabled. ``lock_class`` names the *role* of the lock
    (e.g. ``"HostPool"``), not the instance: ordering bugs are between
    code paths, and all instances of a role share them."""

    __slots__ = ("_lk", "lock_class")

    def __init__(self, lock_class: str) -> None:
        self._lk = threading.Lock()
        self.lock_class = lock_class

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lk.acquire(blocking, timeout)
        if got and _enabled:
            _record_acquire(self.lock_class)
        return got

    def release(self) -> None:
        self._lk.release()
        if _enabled:
            _record_release(self.lock_class)

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # ---- hooks threading.Condition binds via hasattr ------------------
    # Making the wait-release/reacquire pair visible keeps the held stack
    # truthful across Condition.wait() and — crucially — keeps the
    # reacquire from recording edges (see module docstring: a wait
    # resumes an audited hold, it does not pick a new order).
    def _release_save(self) -> Any:
        pos = _record_release(self.lock_class) if _enabled else None
        self._lk.release()
        return pos

    def _acquire_restore(self, state: Any) -> None:
        self._lk.acquire()
        if _enabled:
            _record_wait_reacquire(
                self.lock_class,
                state if state is not None else len(_held_stack()))

    def _is_owned(self) -> bool:
        # probe the raw lock (not the recording acquire): a Condition
        # bookkeeping check must never grow audit edges
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.lock_class!r} at {id(self):#x}>"


def make_lock(lock_class: str) -> SanitizedLock:
    return SanitizedLock(lock_class)


def assert_acyclic() -> None:
    """Raise :class:`LockOrderError` with the offending cycle if the
    recorded acquisition graph has one. Cheap: the graph has one node
    per lock *class*, not per instance."""
    graph = edges()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: list[str] = []

    def visit(n: str) -> list[str] | None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            c = color.setdefault(m, WHITE)
            if c == GRAY:
                return stack[stack.index(m):] + [m]
            if c == WHITE:
                cyc = visit(m)
                if cyc is not None:
                    return cyc
        color[n] = BLACK
        stack.pop()
        return None

    for n in sorted(graph):
        if color[n] == WHITE:
            cyc = visit(n)
            if cyc is not None:
                with _reg_lock:
                    ex = {f"{a}->{b}": _examples.get((a, b), "?")
                          for a, b in zip(cyc, cyc[1:])}
                raise LockOrderError(
                    f"lock acquisition order cycle: {' -> '.join(cyc)} "
                    f"(first seen on threads {ex}) — two code paths take "
                    f"these lock classes in opposite orders")
