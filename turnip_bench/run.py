"""The benchmark's one command:

    python3 turnip_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout. It makes the cell's weights and inputs on
the card from the seed, warms up (set-up), measures whole steps or
requests for ``--seconds``, compares what the measured path produced with
the plain float32 reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from a
profile of the window), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each compared number beside its limit. It fails, printing no
result, without a CUDA card, and if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX pulled in by a library."""
    cache = ROOT / "build" / "turnip_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from turnip_bench import harness
    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"turnip_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all
    build_all()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.driver(cell.traffic["kind"]).run(cell, device, T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"turnip_bench: loaded {banned}: the benchmark runs without "
              f"JAX and the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
