"""The port's training driver (``python -m repro_torch.launch.train``) on
the CPU with ``--arch llama-7b --reduced --device cpu``: the CLI runs and
checkpoints; a run interrupted after its first checkpoint and resumed
(``--resume``), and a run whose step raises once under the supervisor
(right after a checkpoint, or after an unsaved step that it poisons),
give the same losses and the same final state, byte for byte, as an
uninterrupted run; the enc-dec model and the vision frontend train
through it."""
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.ckpt.store import complete_steps, restore_checkpoint
from repro_torch.launch import train as T
from repro_torch.train.tree import flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _args(tmp, *extra):
    return T.parse_args(["--arch", "llama-7b", "--reduced", "--device", "cpu",
                         "--batch", "2", "--seq", "16", "--save-every", "2",
                         "--ckpt-dir", str(tmp), *extra])


def _same(a: dict, b: dict) -> None:
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("lora", [False, True])
def test_resumed_run_equals_uninterrupted(tmp_path, lora):
    extra = ["--lora", "--remat", "offload"] if lora else []
    full = _args(tmp_path / "full", "--steps", "4", *extra)
    want_state, rep, want_losses = T.run(T.setup(full), full)
    assert rep.steps_run == 4 and complete_steps(full.ckpt_dir) == [2, 4]

    first = _args(tmp_path / "cut", "--steps", "2", *extra)
    _, _, l1 = T.run(T.setup(first), first)
    again = _args(tmp_path / "cut", "--steps", "4", "--resume", *extra)
    logs = []
    got_state, rep2, l2 = T.run(T.setup(again), again, log=logs.append)
    assert logs[0] == "resumed from step 2" and rep2.steps_run == 2
    assert l1 + l2 == want_losses
    _same(got_state, want_state)
    if lora:
        assert sorted(got_state["params"])[0] == "layers/attn/wk"


def test_fault_under_the_supervisor_equals_uninterrupted(tmp_path):
    full = _args(tmp_path / "full", "--steps", "4", "--lora")
    want_state, _, want_losses = T.run(T.setup(full), full)
    faulty = _args(tmp_path / "faulty", "--steps", "4", "--lora")
    r = T.setup(faulty)
    left = {"n": 1}

    def step_fn(state, batch):
        if int(state["step"]) == 3 and left["n"]:
            left["n"] -= 1
            raise RuntimeError("injected fault at step 4")
        return r.step_fn(state, batch)
    state, rep, losses = T.run(r, faulty, step_fn=step_fn)
    assert rep.restarts == 1 and "restored@2" in rep.history
    assert losses == want_losses[:3] + want_losses[2:]
    _same(state, want_state)
    ck, step = restore_checkpoint(faulty.ckpt_dir, want_state)
    assert step == 4
    _same(ck, want_state)


def test_fault_after_an_unsaved_step_replays_it_from_disk(tmp_path):
    """A step raises after step 3 has run (no checkpoint holds step 3) and
    leaves the live state poisoned, as a half-applied update would: the
    supervisor restores step 2 from the disk and replays step 3, and the
    final state is the uninterrupted run's, byte for byte."""
    full = _args(tmp_path / "full", "--steps", "4", "--lora")
    want_state, _, want_losses = T.run(T.setup(full), full)
    faulty = _args(tmp_path / "faulty", "--steps", "4", "--lora")
    r = T.setup(faulty)
    left = {"n": 1}

    def step_fn(state, batch):
        if int(state["step"]) == 3 and left["n"]:
            left["n"] -= 1
            for _, leaf in flatten({"p": state["params"], "o": state["opt"]}):
                if leaf.is_floating_point():
                    leaf.fill_(float("nan"))
            raise RuntimeError("injected fault at step 4")
        return r.step_fn(state, batch)
    state, rep, losses = T.run(r, faulty, step_fn=step_fn)
    assert rep.restarts == 1
    assert rep.history[-3:-1] == ["fail@3:RuntimeError", "restored@2"]
    assert losses == want_losses[:3] + want_losses[2:]
    _same(state, want_state)


def test_cli_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama-7b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--grad-accum", "2",
         "--save-every", "2", "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["step 1", "step 2",
                                                      "step 3"]
    assert lines[-1].startswith("done: 3 steps")
    assert complete_steps(tmp_path) == [2, 3]


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_unported_families_raise(tmp_path, arch):
    """The enc-dec model and the vision frontend run 3 reduced LoRA steps
    through ``setup`` and ``run``, as ``main`` calls them, with the
    stub frontend inputs: finite losses, checkpoints written. (The name
    dates from when the launcher refused these two models.)"""
    args = T.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                         "--lora", "--remat", "offload", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--save-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    r = T.setup(args)
    b = r.batch_fn(0)
    stub = ("encoder_embeds" if arch.startswith("seamless")
            else "vision_embeds")
    width = 16 if stub == "encoder_embeds" else r.model.cfg.n_frontend_tokens
    assert tuple(b[stub].shape) == (2, width, r.model.cfg.d_model)
    assert b[stub].dtype == torch.float32 and b[stub].device.type == "cpu"
    # N(0, 1), a function of (seed, step) alone
    assert torch.equal(b[stub], r.batch_fn(0)[stub])
    assert not torch.equal(b[stub], r.batch_fn(1)[stub])
    assert abs(float(b[stub].std()) - 1) < 0.1
    _, report, losses = T.run(r, args, log=lambda s: None)
    assert report.steps_run == 3 and len(losses) == 3
    assert all(math.isfinite(x) for x in losses), losses
    assert complete_steps(tmp_path) == [2, 3]
