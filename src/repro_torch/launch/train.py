"""End-to-end training driver: the port of ``repro/launch/train.py``.

Data pipeline → train step (the model's ``remat``) → checkpoint cadence →
restart on failure through the fault-tolerance supervisor, on the card by
default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-7b \\
        --lora --remat offload --batch 4 --seq 4096 --steps 6 --save-every 2

The reference's options, plus ``--device`` (default CUDA; ``cpu`` runs the
same loop on the CPU, as the tests do) and ``--seed``. Base weights are
drawn on the device from ``torch.Generator(seed)``; LoRA adapters from
``torch.Generator(seed + 1)``. The encoder-decoder family and the vision
frontend are not ported yet (ROADMAP A12) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from ..configs import get_arch, reduced
from ..ckpt.store import latest_step, restore_checkpoint
from ..data.pipeline import DataConfig, SyntheticLMStream
from ..ft.supervisor import Supervisor, SupervisorReport
from ..models import build_model
from ..models.lora import lora_init, make_lora_loss
from ..train.optim import AdamW
from ..train.step import init_train_state, make_train_step

__all__ = ["parse_args", "setup", "run", "main", "Run"]


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--remat", default=None,
                    choices=[None, "full", "dots", "offload"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What :func:`setup` builds: the model, the initial train state, the
    step and batch functions, and (LoRA) the frozen base parameters."""
    model: Any
    state: dict
    step_fn: Callable
    batch_fn: Callable
    base: dict | None = None


def setup(args: argparse.Namespace) -> Run:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "encdec" or cfg.frontend == "vit":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family "
                                  f"and the vision frontend are not ported "
                                  f"yet (ROADMAP A12)")
    model = build_model(cfg, remat=args.remat, device=args.device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    opt = AdamW(lr=args.lr)
    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))
    base = None
    if args.lora:
        base = model.init(gen)
        adapters = lora_init(
            torch.Generator(device=dev).manual_seed(args.seed + 1), base)
        state = {"params": adapters, "opt": opt.init(adapters),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step_fn = make_train_step(model, opt, grad_accum=args.grad_accum,
                                  loss_fn=make_lora_loss(model, base))
    else:
        state = init_train_state(model, gen, opt)
        step_fn = make_train_step(model, opt, grad_accum=args.grad_accum)
    return Run(model, state, step_fn, stream.batch, base)


def run(r: Run, args: argparse.Namespace, *,
        step_fn: Callable | None = None,
        log: Callable[[str], None] = print
        ) -> tuple[dict, SupervisorReport, list[float]]:
    """The supervised loop of ``args.steps`` steps from ``r.state`` (or from
    the latest checkpoint with ``--resume``), checkpointing every
    ``--save-every`` steps. ``step_fn`` replaces ``r.step_fn`` (a wrapper
    that injects a fault, for example). Returns (state, report, the loss
    of every step run)."""
    state, start = r.state, 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir, state)
        log(f"resumed from step {start}")
    fn = step_fn or r.step_fn
    losses: list[float] = []

    def timed_step(state, batch):
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
        log(f"step {int(state['step'])}: loss {losses[-1]:.4f} "
            f"gnorm {float(metrics['grad_norm']):.3f}")
        return state, metrics

    sup = Supervisor(ckpt_dir=args.ckpt_dir, save_every=args.save_every)
    state, report = sup.run(state, timed_step, r.batch_fn, args.steps,
                            start_step=start)
    return state, report, losses


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    t0 = time.time()
    r = setup(args)
    state, report, losses = run(r, args)
    dt = time.time() - t0
    first = f"{losses[0]:.3f}" if losses else "-"
    last = f"{losses[-1]:.3f}" if losses else "-"
    print(f"done: {report.steps_run} steps in {dt:.1f}s "
          f"({report.restarts} restarts); loss {first} → {last}")


if __name__ == "__main__":
    main()
