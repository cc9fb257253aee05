"""Fault tolerance: heartbeat supervision, straggler mitigation, restart.

The port of ``repro/ft/supervisor.py``: the same logic, with the port's
``core.lockcheck`` locks and ``ckpt.store`` checkpoints (the training
state is a dict of tensors). What follows is the reference's own
description.

Scope note (DESIGN.md §5): on a real fleet, per-step collectives are XLA's
job; what the *framework* owns is (a) detecting dead/slow hosts, (b)
checkpoint/restart with elastic re-mesh, and (c) straggler mitigation for
host-side work — which TURNIP's nondeterministic dispatch makes natural:
a vertex assigned to a slow worker can simply be re-dispatched elsewhere,
because any dependency-respecting executor is valid (paper §5).

Components:

* :class:`Heartbeat` — worker liveness with configurable timeout.
* :class:`Supervisor` — drives a train loop: run step → on failure, restore
  the latest complete checkpoint (ckpt.store guarantees atomicity) and
  continue, optionally on a different worker count (the data pipeline is
  topology-independent, so the stream is unaffected).
* :func:`speculative_redispatch` — TURNIP-side straggler mitigation: when a
  vertex's runtime exceeds ``factor``× the median for its op type, a clone
  is dispatched on another free stream; first completion wins (results are
  idempotent writes to the planned extent).
* :class:`SpeculativeLedger` — the dedup around that rule: at most one
  clone per straggler, first completion retires the vertex, losers are
  counted as waste and never double-applied.

The serving fleet reuses the same machinery (DESIGN.md §16): the router
beats each replica's heartbeat from the replica's own run loop and drains
replicas the supervisor declares dead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from ..core import lockcheck

__all__ = ["Heartbeat", "Supervisor", "SpeculativeLedger",
           "speculative_redispatch"]


class Heartbeat:
    """Worker liveness. Beats arrive from worker threads while the
    supervisor polls from the driver, so the table is lock-protected —
    a :class:`~repro_torch.core.lockcheck.SanitizedLock` leaf, so the training
    side participates in the suite-wide acquisition-order audit."""

    def __init__(self, timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s
        self.last_beat: dict[str, float] = {}
        self._lock = lockcheck.make_lock("Heartbeat")

    def beat(self, worker: str, now: float | None = None) -> None:
        stamp = time.monotonic() if now is None else now
        with self._lock:
            self.last_beat[worker] = stamp

    def dead_workers(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return [w for w, t in self.last_beat.items()
                    if now - t > self.timeout_s]

    def forget(self, worker: str) -> None:
        """Drop a worker from the table: a drained/retired replica must
        not keep reporting dead on every later poll."""
        with self._lock:
            self.last_beat.pop(worker, None)


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int
    restarts: int
    final_step: int
    history: list[str]


class Supervisor:
    """Run-to-completion driver with checkpoint/restart.

    ``step_fn(state, batch) -> (state, metrics)`` may raise — any exception
    triggers restore-from-latest + resume. ``save_every`` controls the
    checkpoint cadence; the data stream is addressed purely by step index.
    """

    def __init__(self, *, ckpt_dir: str, save_every: int = 10,
                 max_restarts: int = 5,
                 backoff_s: float = 0.0, max_backoff_s: float = 30.0,
                 heartbeat: Heartbeat | None = None) -> None:
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        # restart-storm damping: the k-th consecutive restart sleeps
        # backoff_s * 2**(k-1), capped at max_backoff_s (0 = no backoff —
        # the prior behaviour). A crash loop with a persistent cause
        # (bad host, poisoned batch) otherwise burns its restart budget in
        # milliseconds and turns one fault into max_restarts of churn.
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.heartbeat = heartbeat if heartbeat is not None else Heartbeat()
        # guards the live progress record (step/restarts/history): a
        # monitor thread reads status() while run() mutates. Documented
        # order: Supervisor -> Heartbeat (run() beats under its own
        # lock); the sanitizer audits it with the rest of the fleet.
        self._lock = lockcheck.make_lock("Supervisor")
        self._step = 0
        self._restarts = 0
        self._history: list[str] = []

    def status(self) -> tuple[int, int, list[str]]:
        """(current step, restarts so far, history copy) — safe to call
        from a monitor thread while ``run`` is live."""
        with self._lock:
            return self._step, self._restarts, list(self._history)

    def _note(self, step: int, entry: str | None = None,
              restarted: bool = False) -> None:
        with self._lock:
            self._step = step
            if restarted:
                self._restarts += 1
            if entry is not None:
                self._history.append(entry)
            self.heartbeat.beat("driver")

    def run(self, state: Any, step_fn: Callable, batch_fn: Callable,
            n_steps: int, *, start_step: int = 0) -> tuple[Any, SupervisorReport]:
        from ..ckpt.store import latest_step, restore_checkpoint, \
            save_checkpoint
        restarts = 0
        step = start_step
        steps_run = 0
        with self._lock:
            self._step, self._restarts = step, 0
            self._history = []
        history = self._history
        while step < n_steps:
            try:
                state, metrics = step_fn(state, batch_fn(step))
                steps_run += 1
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    save_checkpoint(self.ckpt_dir, step, state)
                    self._note(step, f"ckpt@{step}")
                else:
                    self._note(step)
            except Exception as e:   # noqa: BLE001 — any failure → restart
                restarts += 1
                self._note(step, f"fail@{step}:{type(e).__name__}",
                           restarted=True)
                if restarts > self.max_restarts:
                    raise
                last = latest_step(self.ckpt_dir)
                if last is None:
                    raise
                if self.backoff_s > 0:
                    delay = min(self.backoff_s * 2 ** (restarts - 1),
                                self.max_backoff_s)
                    self._note(step, f"backoff@{step}:{delay:.4g}s")
                    time.sleep(delay)
                state, step = restore_checkpoint(self.ckpt_dir, state)
                self._note(step, f"restored@{step}")
        return state, SupervisorReport(steps_run, restarts, step,
                                       list(history))


class SpeculativeLedger:
    """Dedup around :func:`speculative_redispatch`: at most one clone per
    straggling vertex, and once either copy completes the vertex is
    retired — the losing completion is counted as waste and must be
    dropped, never applied twice. Results are idempotent writes to planned
    extents, so correctness never *depends* on this class; what it buys is
    bounded speculation (no clone storms when the policy keeps flagging
    the same straggler every wakeup) and an audit trail."""

    def __init__(self) -> None:
        # leaf lock: completions arrive from worker threads while the
        # driver's wakeup loop asks try_clone
        self._lock = lockcheck.make_lock("SpeculativeLedger")
        self._inflight: set[int] = set()
        self._done: set[int] = set()
        self.cloned = 0
        self.wasted = 0          # completions that lost the race

    def try_clone(self, mid: int) -> bool:
        """True exactly once per straggling vertex until it completes —
        the caller dispatches the clone iff this returns True."""
        with self._lock:
            if mid in self._inflight or mid in self._done:
                return False
            self._inflight.add(mid)
            self.cloned += 1
            return True

    def complete(self, mid: int) -> bool:
        """Record a completion (original or clone). True for the winner
        (apply the result); False for the loser (drop it)."""
        with self._lock:
            if mid in self._done:
                self.wasted += 1
                return False
            self._done.add(mid)
            self._inflight.discard(mid)
            return True


def speculative_redispatch(durations: dict[int, float], op_medians:
                           dict[str, float], vertex_ops: dict[int, str],
                           *, factor: float = 3.0) -> list[int]:
    """Straggler rule: vertices running ≥ factor× the median duration of
    their op class are candidates for speculative re-dispatch. Pure policy
    function (unit-tested; the threaded runtime consults it per event-loop
    wakeup)."""
    out = []
    for mid, dur in durations.items():
        med = op_medians.get(vertex_ops.get(mid, ""), None)
        if med is not None and med > 0 and dur >= factor * med:
            out.append(mid)
    return out
