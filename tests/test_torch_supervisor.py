"""The port's fault-tolerance substrate (``repro_torch.ft.supervisor``):
case-for-case twins of ``tests/test_supervisor.py`` (missed-heartbeat
detection latency, restart-storm backoff, speculative re-dispatch dedup),
with the train state a dict of torch tensors checkpointed by the port's
store; plus ``status()`` while a run is live and a restart that restores
the exact bytes of the last checkpoint.
"""
import threading
import time

import pytest
import torch

from repro_torch.ft.supervisor import (Heartbeat, SpeculativeLedger, Supervisor,
                                 speculative_redispatch)


# -------------------------------------------------------------- heartbeat
class TestHeartbeatDetection:
    def test_detection_latency_bounds(self):
        """A silent worker is reported dead no earlier than ``timeout_s``
        after its last beat and immediately after — the detection latency
        is the timeout, not a multiple of it."""
        hb = Heartbeat(timeout_s=2.0)
        hb.beat("w", now=100.0)
        assert hb.dead_workers(now=101.9) == []
        assert hb.dead_workers(now=102.0) == []      # boundary: not yet
        assert hb.dead_workers(now=102.01) == ["w"]  # one epsilon past

    def test_beat_resets_the_clock(self):
        hb = Heartbeat(timeout_s=1.0)
        hb.beat("w", now=0.0)
        hb.beat("w", now=5.0)
        assert hb.dead_workers(now=5.5) == []
        assert hb.dead_workers(now=6.5) == ["w"]

    def test_forget_retires_a_drained_worker(self):
        """A drained replica must stop reporting dead on every later poll
        — otherwise the fleet monitor re-drains a corpse forever."""
        hb = Heartbeat(timeout_s=1.0)
        hb.beat("a", now=0.0)
        hb.beat("b", now=0.0)
        assert sorted(hb.dead_workers(now=10.0)) == ["a", "b"]
        hb.forget("a")
        assert hb.dead_workers(now=10.0) == ["b"]
        hb.forget("a")                      # idempotent
        assert hb.dead_workers(now=10.0) == ["b"]

    def test_concurrent_beats_and_polls(self):
        """Beats from worker threads racing the supervisor's poll: the
        table stays consistent and a live beater is never reported."""
        hb = Heartbeat(timeout_s=0.5)
        stop = threading.Event()

        def beater():
            while not stop.is_set():
                hb.beat("live")

        t = threading.Thread(target=beater)
        t.start()
        try:
            hb.beat("dead", now=time.monotonic() - 10.0)
            for _ in range(50):
                assert hb.dead_workers() == ["dead"]
        finally:
            stop.set()
            t.join(timeout=5)
        assert not t.is_alive()


# ---------------------------------------------------------------- backoff
class TestRestartBackoff:
    @staticmethod
    def _crashy(n_crashes, at=3):
        crashes = {"left": n_crashes}

        def step_fn(state, batch):
            if state["x"] == at and crashes["left"]:
                crashes["left"] -= 1
                raise RuntimeError("injected")
            return {"x": state["x"] + 1}, {}

        return step_fn

    def test_storm_sleeps_exponentially(self, tmp_path, monkeypatch):
        """Three consecutive crashes at the same step: the k-th restart
        sleeps backoff_s * 2**(k-1), capped — one fault never burns the
        restart budget in milliseconds."""
        slept = []
        monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
        sup = Supervisor(ckpt_dir=str(tmp_path), save_every=2,
                         backoff_s=0.1, max_backoff_s=0.25)
        state, report = sup.run({"x": torch.zeros(())},
                                self._crashy(3, at=3),
                                lambda s: None, 8)
        assert report.final_step == 8 and float(state["x"]) == 8
        assert report.restarts == 3
        assert slept == [0.1, 0.2, 0.25]         # doubled, then capped
        assert sum(h.startswith("backoff@") for h in report.history) == 3

    def test_zero_backoff_is_the_prior_behaviour(self, tmp_path,
                                                 monkeypatch):
        slept = []
        monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
        sup = Supervisor(ckpt_dir=str(tmp_path), save_every=2)
        _, report = sup.run({"x": torch.zeros(())},
                            self._crashy(2, at=3), lambda s: None, 6)
        assert report.restarts == 2
        assert slept == []
        assert not any(h.startswith("backoff@") for h in report.history)

    def test_budget_still_enforced_under_backoff(self, tmp_path,
                                                 monkeypatch):
        """Backoff damps the storm but never hides it: a persistent crash
        still exhausts max_restarts and re-raises."""
        monkeypatch.setattr(time, "sleep", lambda s: None)
        sup = Supervisor(ckpt_dir=str(tmp_path), save_every=1,
                         max_restarts=2, backoff_s=0.01)
        with pytest.raises(RuntimeError, match="injected"):
            sup.run({"x": torch.zeros(())},
                    self._crashy(99, at=2), lambda s: None, 6)


# ---------------------------------------------- speculative re-dispatch
class TestSpeculativeLedger:
    def test_at_most_one_clone_per_straggler(self):
        led = SpeculativeLedger()
        assert led.try_clone(7)
        assert not led.try_clone(7)      # already in flight
        assert led.cloned == 1

    def test_winner_applies_loser_drops(self):
        """The dedup that makes speculation safe: whichever completion
        lands second must be dropped, never applied twice."""
        led = SpeculativeLedger()
        assert led.try_clone(7)
        assert led.complete(7)           # first completion wins
        assert not led.complete(7)       # the straggler's late finish
        assert led.wasted == 1
        # a retired vertex is never re-cloned, even if the policy keeps
        # flagging it as slow on later wakeups
        assert not led.try_clone(7)

    def test_policy_flags_only_true_stragglers(self):
        durations = {1: 0.9, 2: 3.1, 3: 0.2}
        medians = {"matmul": 1.0, "copy": 0.1}
        ops = {1: "matmul", 2: "matmul", 3: "copy"}
        assert speculative_redispatch(durations, medians, ops,
                                      factor=3.0) == [2]

    def test_race_never_double_executes(self):
        """N threads race the same straggler through the ledger: exactly
        one clone dispatch and exactly one applied completion, on any
        interleaving."""
        led = SpeculativeLedger()
        clones, applies = [], []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            if led.try_clone(42):
                clones.append(i)
            if led.complete(42):
                applies.append(i)

        threads = [threading.Thread(target=racer, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert len(clones) == 1
        assert len(applies) == 1
        assert led.wasted == 7


class TestPortSupervisor:
    def test_status_while_running(self, tmp_path):
        seen = []
        sup = Supervisor(ckpt_dir=str(tmp_path), save_every=2)

        def step_fn(state, batch):
            seen.append(sup.status())
            return {"x": state["x"] + 1}, {}

        state, report = sup.run({"x": torch.zeros(())}, step_fn,
                                lambda s: None, 4)
        assert [s[0] for s in seen] == [0, 1, 2, 3]
        assert sup.status()[0] == 4 and report.history == ["ckpt@2",
                                                           "ckpt@4"]

    def test_restart_restores_checkpointed_bytes(self, tmp_path):
        """After a fault the run resumes from the last checkpoint's exact
        tensors (here a random walk whose steps depend on the state), so
        the final state equals an uninterrupted run's, byte for byte."""
        def step_fn(state, batch):
            g = torch.Generator().manual_seed(int(state["n"]))
            return {"w": state["w"] + torch.randn(4, 4, generator=g),
                    "n": state["n"] + 1}, {}

        crashed = {"left": 1}

        def faulty(state, batch):
            if int(state["n"]) == 3 and crashed["left"]:
                crashed["left"] -= 1
                raise RuntimeError("injected")
            return step_fn(state, batch)

        init = {"w": torch.zeros(4, 4), "n": torch.tensor(0)}
        want, _ = Supervisor(ckpt_dir=str(tmp_path / "a"),
                             save_every=2).run(init, step_fn,
                                               lambda s: None, 5)
        got, report = Supervisor(ckpt_dir=str(tmp_path / "b"),
                                 save_every=2).run(init, faulty,
                                                   lambda s: None, 5)
        assert report.restarts == 1 and "restored@2" in report.history
        assert torch.equal(got["w"], want["w"]) and int(got["n"]) == 5
