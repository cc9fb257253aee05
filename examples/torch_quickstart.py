"""Quickstart on the PyTorch/CUDA port: the TURNIP pipeline end to end in
one page, the twin of ``examples/quickstart.py``.

1. Build a TASKGRAPH (the paper's Fig. 3 running example).
2. Compile it to a MEMGRAPH under a 3-slot-per-device budget — offload and
   reload vertices appear, with the safe-overwrite memory dependencies.
3. Execute it with the nondeterministic event-driven runtime on the card
   and check that the result equals direct dataflow evaluation.
4. Compare fixed-order vs nondeterministic dispatch in the discrete-event
   simulator (the paper's §8 ablation).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import BuildConfig, TaskGraph, build_memgraph
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.simulate import HardwareModel, simulate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    # -- 1. TASKGRAPH (paper Fig. 3: sliced matmul on three devices) -------
    tg = TaskGraph()
    A = tg.add_input(0, (64, 64), name="A")
    B = tg.add_input(0, (64, 64), name="B")
    C = tg.add_input(1, (64, 64), name="C")
    D = tg.add_input(1, (64, 64), name="D")
    v1 = tg.add_compute(0, (A, B), (64, 64), op="matmul", name="1")
    v2 = tg.add_compute(0, (A, B), (64, 64), op="matmul_t", name="2")
    v5 = tg.add_compute(1, (C, D), (64, 64), op="matmul", name="5")
    v6 = tg.add_compute(1, (C, D), (64, 64), op="matmul_t", name="6")
    t25 = tg.add_transfer(1, v2)
    t61 = tg.add_transfer(0, v6)
    v3 = tg.add_compute(0, (v1, t61), (64, 64), op="add", name="3")
    v7 = tg.add_compute(1, (v5, t25), (64, 64), op="add", name="7")
    tg.add_transfer(2, v7)
    v4 = tg.add_compute(0, (v3, t61), (64, 64), op="mul", name="4")
    tg.add_compute(0, (v4, v3), (64, 64), op="mul", name="8")

    # -- 2. compile under pressure: 3 tensor slots per device ---------------
    res = build_memgraph(tg, BuildConfig(capacity=3, size_fn=lambda v: 1))
    res.memgraph.validate(check_races=True)
    print("MEMGRAPH:", res.memgraph.stats())
    print(f"offloads={res.n_offloads} reloads={res.n_reloads} "
          f"peak={res.peak_used}")

    # -- 3. execute: any dependency-respecting order is correct -------------
    rng = np.random.default_rng(0)
    inputs = {t: rng.integers(-3, 4, (64, 64)).astype(np.float64)
              for t in (A, B, C, D)}
    ref = eval_taskgraph(tg, inputs, device=args.device)
    for policy in ("random", "critical-path", "transfer-first"):
        rr = TurnipRuntime(tg, res, mode="nondet", policy=policy, seed=42,
                           device=args.device).run(inputs)
        ok = all(torch.equal(rr.outputs[k], ref[k]) for k in ref)
        print(f"nondet ({policy:>14s} dispatch) matches dataflow "
              f"oracle: {ok}")

    # -- 4. the paper's ablation in the simulator ---------------------------
    hw = HardwareModel(transfer_jitter=0.8, seed=7)
    nd = simulate(res.memgraph, hw, mode="nondet")
    fx = simulate(res.memgraph, hw, mode="fixed")
    print(f"simulated makespan: nondet={nd.makespan*1e6:.0f}us "
          f"fixed={fx.makespan*1e6:.0f}us "
          f"(fixed/nondet = {fx.makespan/nd.makespan:.2f}x)")


if __name__ == "__main__":
    main()
