"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 turnip_bench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--out <file>]

for a training cell. For each seed: the program's numbers against the
float32 reference from its checked steps, which need no window (the lower
readings). For each control seed also the control, the reference with
float8 products put in the program's place (the upper readings), and the
fault of half of each batch left out, planted in the reference put in the
program's place. Each reading is one JSON line on standard output and in
``--out``.
"""
import argparse
import json
import sys
import time

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from turnip_bench import harness
    from turnip_bench.drivers import train
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all
    build_all()
    dev = torch.device("cuda", 0)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")

    for seed in args.seeds:
        cell = harness.load_cell(args.workload, seed, 0.0, False)
        if cell.traffic["kind"] != "train":
            print(f"calibrate: no readings for the {cell.traffic['kind']!r} "
                  f"kind", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        run = train.Train(cell, dev)
        run.setup()
        t_prog = time.perf_counter() - t0
        prog = run.evidence
        run.free_program()
        peak = torch.cuda.max_memory_allocated(dev)
        t1 = time.perf_counter()
        ref = run.reference()
        t_ref = time.perf_counter() - t1
        emit({"workload": cell.name, "seed": seed, "side": "program",
              "numbers": train.numbers(prog, ref, run.adapters0), "program_s": t_prog,
              "reference_s": t_ref, "program_peak_bytes": peak})
        if seed in args.control_seeds:
            t1 = time.perf_counter()
            ctrl = run.reference("fp8")
            emit({"workload": cell.name, "seed": seed, "side": "control_fp8",
                  "numbers": train.numbers(ctrl, ref, run.adapters0),
                  "seconds": time.perf_counter() - t1})
            t1 = time.perf_counter()
            half = run.reference(half=True)
            emit({"workload": cell.name, "seed": seed,
                  "side": "fault_half_batch",
                  "numbers": train.numbers(half, ref, run.adapters0),
                  "seconds": time.perf_counter() - t1})
        del run, prog, ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
