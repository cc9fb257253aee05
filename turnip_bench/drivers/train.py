"""Training traffic: LoRA fine-tuning steps of one model, closed loop,
whole steps, every batch a different set of rows of the frozen stream.

Traffic file keys: ``batch``, ``seq_len``, ``remat`` (the model's
activation-checkpoint mode), ``lora`` (``rank``, ``alpha``, ``b_scale``),
``optimizer`` (AdamW's ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``),
``checked_steps`` (the first steps, in set-up, that the reference
follows) and ``pool`` (batches made in set-up; the window cycles through
them after the checked ones).

The program under test is ``make_train_step(build_model(cfg,
remat=...), AdamW(...), loss_fn=make_lora_loss(...))``; the benchmark makes
the base weights, the adapters and the batches and hands the same to the
reference. ``correct`` compares, against the float32 reference, each
checked step's loss (``loss_gap``), the first gradient as AdamW's first
moment holds it after one step (``grad_gap``, by the worst leaf: the gap
of the norms over the larger of the reference's norm and the median
leaf's) and each leaf's change after the checked steps (``change_gap``,
the same measure, leaves whose reference gradient is under a thousandth
of the median leaf's left out).
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from .. import harness, stream, trace
from ..reference import common

__all__ = ["Train", "run", "numbers"]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median of ref)."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return float("nan")
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def _leaf(tree: dict, pk: tuple) -> torch.Tensor:
    return tree[pk[0]][pk[1]].float()


def _worst_diff(prog: dict, ref: dict, scale: dict, keep) -> float:
    """max over leaves of |prog - ref| / max(|ref|, the median |ref|)."""
    keys = [k for k in scale if k in keep]
    med = statistics.median(scale[k] for k in keys)
    return max(_norm(prog[k] - ref[k]) / max(scale[k], med, 1e-30)
               for k in keys)


def numbers(prog: dict, ref: dict, adapters0: dict) -> dict:
    """The numbers of a run (``prog``) against the reference (``ref``);
    both hold ``loss`` (per checked step), ``grad1`` and ``adapters`` as
    ``common.train`` returns them. ``loss_gap``, ``grad_gap`` and
    ``change_gap`` are the gaps of the losses and of the leaves' norms;
    ``grad_dir_gap`` and ``change_dir_gap`` the norm of the leaves'
    difference, by the worst leaf over the larger of the reference's norm
    and the median leaf's."""
    leaves = [(p, k) for p in sorted(adapters0) for k in ("A", "B")]
    g_prog = {pk: _leaf(prog["grad1"], pk) for pk in leaves}
    g_ref = {pk: _leaf(ref["grad1"], pk) for pk in leaves}
    gn_ref = {pk: _norm(g) for pk, g in g_ref.items()}
    med_g = statistics.median(gn_ref.values())
    moved = {pk for pk in leaves if gn_ref[pk] >= 1e-3 * med_g}

    def change(out):
        return {pk: _leaf(out["adapters"], pk) - _leaf(adapters0, pk)
                for pk in leaves}
    d_prog, d_ref = change(prog), change(ref)
    dn_ref = {pk: _norm(d) for pk, d in d_ref.items()}
    n = min(len(prog["loss"]), len(ref["loss"]))
    loss_gap = max(abs(prog["loss"][k] - ref["loss"][k])
                   / abs(ref["loss"][k]) for k in range(n))
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_gap({k: _norm(v) for k, v in g_prog.items()},
                                   gn_ref),
            "change_gap": _worst_gap({k: _norm(v) for k, v in d_prog.items()},
                                     dn_ref, moved),
            "grad_dir_gap": _worst_diff(g_prog, g_ref, gn_ref, set(leaves)),
            "change_dir_gap": _worst_diff(d_prog, d_ref, dn_ref, moved)}


class Train:
    """One cell's training run, in the steps a run and the calibration
    take: ``setup`` (weights, the program, its checked steps), ``window``,
    ``free_program``, ``reference``."""

    def __init__(self, cell: harness.Cell, device: torch.device) -> None:
        self.cell, self.dev = cell, device
        tr = cell.traffic
        self.B, self.S = tr["batch"], tr["seq_len"]
        self.K = tr["checked_steps"]
        self.hp = dict(tr["optimizer"])
        lo = tr["lora"]
        self.rank, self.alpha = lo["rank"], lo["alpha"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.configs.base import ArchConfig
        from repro_torch.models import build_model
        from repro_torch.models.lora import make_lora_loss
        from repro_torch.train.optim import AdamW
        from repro_torch.train.step import make_train_step

        cell, dev, tr = self.cell, self.dev, self.cell.traffic
        arch = cell.arch
        fam = harness.reference(arch["family"])
        gen = torch.Generator(device=dev).manual_seed(cell.seed)
        self.params = common.make_weights(fam.weight_specs(cell.config), gen,
                                          dev)
        fam.finish_weights(self.params, cell.config)
        self.adapters0 = common.make_adapters(self.params, gen, self.rank,
                                              tr["lora"]["b_scale"])
        pool = stream.train_batches(tr["pool"], self.B, self.S,
                                    arch["vocab_size"], cell.seed)
        pin = dev.type == "cuda"
        self.pool = [{k: (torch.from_numpy(v).pin_memory() if pin
                          else torch.from_numpy(v)) for k, v in b.items()}
                     for b in pool]
        model = build_model(ArchConfig(**arch), remat=tr["remat"],
                            device=dev)
        opt = AdamW(**self.hp)
        self.step = make_train_step(
            model, opt, loss_fn=make_lora_loss(model, self.params,
                                               alpha=self.alpha,
                                               rank=self.rank))
        ad = {p: {k: t.clone() for k, t in ab.items()}
              for p, ab in self.adapters0.items()}
        self.state = {"params": ad, "opt": opt.init(ad),
                      "step": torch.zeros((), dtype=torch.int32, device=dev)}
        losses = []
        for k in range(self.K):
            self.state, m = self.step(self.state, self._feed(k))
            losses.append(m["loss"])
            if k == 0:
                b1 = self.hp["b1"]
                grad1 = {p: {n: t / (1 - b1) for n, t in mab.items()}
                         for p, mab in self.state["opt"]["m"].items()}
        self.evidence = {
            "loss": [float(x) for x in losses], "grad1": grad1,
            "adapters": {p: {k: t.clone() for k, t in ab.items()}
                         for p, ab in self.state["params"].items()}}
        self.next = self.K
        _sync(dev)

    def _feed(self, i: int) -> dict:
        return {k: v.to(self.dev, non_blocking=True)
                for k, v in self.pool[i % len(self.pool)].items()}

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        """Whole steps until ``seconds`` have passed, ending at a
        synchronise; the batches' hand-over timed by the host clock."""
        dev = self.dev
        counters0 = harness.program_counters(self.cell)
        feed_s, losses = [], []
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                batch = self._feed(self.next)
                feed_s.append(time.perf_counter() - t)
                self.state, m = self.step(self.state, batch)
                losses.append(m["loss"])
                self.next += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(dev)
            window_s = time.perf_counter() - t0
        counters = {k: v - counters0[k] for k, v in
                    harness.program_counters(self.cell).items()}
        failed = sum(1 for x in losses if not torch.isfinite(x).item())
        return {"window_s": window_s, "steps": len(losses), "failed": failed,
                "feed_s": feed_s, "counters": counters}

    def free_program(self) -> None:
        for name in ("step", "state"):
            setattr(self, name, None)
        _sync(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------- reference
    def reference(self, precision: str = "fp32", half: bool = False) -> dict:
        """The first ``checked_steps`` steps in plain float32 (or with
        ``precision='fp8'`` products, the control; ``half`` keeps half of
        each batch, a fault read in the reference's place)."""
        common.exact()
        fam = harness.reference(self.cell.arch["family"])
        model = fam.Reference(self.cell.arch, self.params,
                              precision=precision,
                              lora_scale=self.alpha / self.rank)
        rows = self.B // 2 if half else self.B
        batches = [{k: v[:rows].to(self.dev) for k, v in
                    self.pool[k_].items()} for k_ in range(self.K)]
        return common.train(model, batches, self.adapters0, self.hp, self.K)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: harness.Cell, device: torch.device, t_start: float) -> dict:
    """One run of a training cell: set-up, the window (traced or not), the
    reference, the result line."""
    t = Train(cell, device)
    t.setup()
    setup_s = time.perf_counter() - t_start
    w, dev_info, peak, tl = harness.measure(cell, device,
                                            lambda: t.window(cell.seconds))
    tokens = w["steps"] * t.B * t.S
    breakdown = None
    if tl is not None:
        metrics, breakdown = harness.traced_metrics(harness.Run(
            cell=cell, window_s=tl.window_s, units=w["steps"],
            lengths=[[t.S] * t.B] * w["steps"], timeline=tl,
            spans={"feed": w["feed_s"]}, counters=w["counters"],
            peak_bytes=peak))
    else:
        metrics = {"train_tokens_per_s": {"value": tokens / w["window_s"],
                                          "unit": "tokens/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    print(f"window: {w['steps']} steps, {w['window_s']!r} s, "
          f"{tokens / w['window_s']!r} tokens/s; set-up {setup_s!r} s; "
          f"{harness.power_limit()}", file=sys.stderr)
    t.free_program()
    nums = numbers(t.evidence, t.reference(), t.adapters0)
    print(f"numbers: {nums}", file=sys.stderr)
    ok, block = harness.checks_block(nums, cell.limits)
    harness.print_checks(block)
    return harness.result_line(
        correct=ok and w["failed"] == 0, attempted=w["steps"],
        failed=w["failed"], metrics=metrics, device=dev_info, checks=block,
        breakdown=breakdown)
