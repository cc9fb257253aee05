"""On the card (skipped without one): the tiny float32 cell through the
driver, the port's kernels against the plain reference, and the result
line of a whole traced run. The cell's own size is the benchmark's runs."""
from __future__ import annotations

import time

import pytest

from turnip_bench import harness
from turnip_bench.drivers import train

from conftest import tiny_cell

pytestmark = pytest.mark.cuda


def test_training_kernels_agree_with_the_reference(cuda_device):
    t = train.Train(tiny_cell(), cuda_device)
    t.setup()
    t.window(0.2)
    t.free_program()
    nums = train.numbers(t.evidence, t.reference(), t.adapters0)
    assert nums["loss_gap"] < 1e-4 and nums["grad_gap"] < 1e-3, nums


def test_a_traced_run_reads_the_device(cuda_device):
    cell = tiny_cell(seconds=0.5, trace=True)
    out = harness.driver("train").run(cell, cuda_device, time.perf_counter())
    assert out["correct"] and out["device"]["busy_s"] > 0
    for name in ("idle_share.train", "offload_gib.train",
                 "wkv6_bwd_roofline.train"):
        assert name in out["metrics"], name
