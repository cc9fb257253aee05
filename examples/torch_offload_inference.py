"""Paper task 1 at example scale on the PyTorch/CUDA port, the twin of
``examples/offload_inference.py``: trace a transformer, compile MEMGRAPHs
under shrinking device budgets, execute with the threaded runtime on the
card, and report how offload traffic and simulated latency grow as memory
shrinks (a miniature Fig. 10). The oracle check, ``close``: every logit
within 1e-5 of the largest logit of the dataflow oracle (the runtime's
sliced products sum in another order; the original's elementwise
``rtol=1e-5`` fails on logits near zero, which is no fault of the plan).

    PYTHONPATH=src python examples/torch_offload_inference.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, MemgraphOOM, POLICY_NAMES,
                              build_memgraph)
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.simulate import HardwareModel, simulate
from repro_torch.core.trace import TraceConfig, trace_prefill


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    cfg = ArchConfig(name="demo-120m", family="dense", n_layers=args.layers,
                     d_model=256, n_heads=8, n_kv_heads=8, d_ff=1024,
                     vocab_size=512)
    tr = trace_prefill(cfg, seq_len=args.seq, trace=TraceConfig(
        n_devices=2, head_group=2, q_block=64, mlp_slices=2))
    inputs = tr.make_inputs(seed=1, scale=0.1)
    ref = eval_taskgraph(tr.tg, inputs, device=args.device)
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    hw = HardwareModel(flops=9e12, h2d_bw=11e9, d2h_bw=11e9,
                       transfer_jitter=0.5, seed=0)
    print(f"graph: {tr.tg.stats()}")
    print(f"{'budget':>8s} {'offloads':>9s} {'reloads':>8s} "
          f"{'sim ms':>8s} {'close':>6s}")
    tightest = None
    for frac in (1.0, 0.5, 0.25, 0.12, 0.05):
        cap = int(total * frac)
        try:
            res = build_memgraph(tr.tg, BuildConfig(capacity=cap))
        except MemgraphOOM:
            print(f"{frac:8.2f} {'OOM':>9s}")
            continue
        rr = TurnipRuntime(tr.tg, res, mode="nondet", seed=0,
                           device=args.device).run(inputs)
        logits = tr.meta["logits"]
        want = ref[logits].float()
        close = bool(((rr.outputs[logits].float() - want).abs()
                      <= 1e-5 * want.abs().max()).all())
        sim = simulate(res.memgraph, hw)
        print(f"{frac:8.2f} {res.n_offloads:9d} {res.n_reloads:8d} "
              f"{sim.makespan*1e3:8.2f} {str(close):>6s}")
        tightest = res

    # dispatch-policy ablation at the tightest feasible budget: same graph,
    # same memory plan, different ready-queue ranking (simulated makespan)
    if tightest is not None:
        print("\ndispatch policies at tightest budget "
              f"({tightest.n_reloads} reloads):")
        fixed_ms = simulate(tightest.memgraph, hw, mode="fixed").makespan
        for policy in POLICY_NAMES:
            sim = simulate(tightest.memgraph, hw, policy=policy)
            print(f"  {policy:>14s}: {sim.makespan*1e3:8.2f} ms "
                  f"(fixed-issue order: {fixed_ms/sim.makespan:.2f}x slower)")


if __name__ == "__main__":
    main()
