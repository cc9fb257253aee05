"""The comparison that decides ``correct``, at a tiny size on the CPU: the
port against the plain reference (float32 on both sides: they agree to
rounding), the control (the reference with float8 products in the
program's place) failing the cell's limits, and whole driver runs with
the measured path broken underneath coming out not correct."""
from __future__ import annotations

import time

import pytest
import torch

from turnip_bench import harness
from turnip_bench.drivers import train

from conftest import tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trained():
    t = train.Train(tiny_cell(), CPU)
    t.setup()
    t.window(0.05)
    t.free_program()
    return t, t.reference()


def test_port_agrees_with_the_reference_in_float32(trained):
    t, ref = trained
    nums = train.numbers(t.evidence, ref, t.adapters0)
    assert nums["loss_gap"] < 1e-6
    assert nums["grad_gap"] < 1e-5 and nums["change_gap"] < 1e-5


def test_control_fails_the_training_limits(trained):
    t, ref = trained
    nums = train.numbers(t.reference("fp8"), ref, t.adapters0)
    ok, _ = harness.checks_block(nums, t.cell.limits)
    assert not ok, nums


def _broken(make, fault):
    """``make_train_step`` whose step is broken by ``fault``: ``frozen``
    hands back the state it was given, ``half`` leaves out half of each
    batch, ``answer`` doubles one adapter leaf's update."""
    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, batch):
            if fault == "half":
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            new, metrics = step(state, batch)
            if fault == "frozen":
                return state, metrics
            if fault == "answer":
                p = sorted(new["params"])[0]
                a, a0 = new["params"][p]["A"], state["params"][p]["A"]
                new["params"][p]["A"] = a0 + 2 * (a - a0)
            return new, metrics
        return broken
    return make_broken


@pytest.mark.parametrize("fault", [None, "frozen", "half", "answer"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    """A whole run past the look for a card: sound, it is correct; with a
    step that returns its state unchanged, half of the batch left out, or
    an answer altered where it is produced, it is not."""
    if fault is not None:
        from repro_torch.train import step as step_mod
        monkeypatch.setattr(step_mod, "make_train_step",
                            _broken(step_mod.make_train_step, fault))
    cell = tiny_cell(seconds=0.05)
    out = harness.driver(cell.traffic["kind"]).run(cell, CPU,
                                                   time.perf_counter())
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
