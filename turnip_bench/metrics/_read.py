"""What several per-layer metrics share: GEMM kernels by name and a
roofline share of an operator's calls."""
from __future__ import annotations

import sys

from .. import trace

# cuBLAS and CUTLASS GEMM kernels on Hopper (``nvjet_*``, ``sm90_xmma_*``,
# ``cutlass_*``, ``*gemm*``); the port's own kernels are named attn_*,
# gmm_*, rmsnorm_*, ssd_* and wkv6_*
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
BYTES_F32 = 4              # the scans run on float32 inputs
MIN_FOUND = 0.99           # share of the launched calls a trace must hold


def gemm_seconds(run) -> float:
    return sum(e - s for name, s, e, _ in run.timeline.kernels
               if any(m in name.lower() for m in GEMM_MARKS))


def roofline_share(run, pattern: list[str], counter: str,
                   bound_s: float) -> float | None:
    """100 x (the least time of one of the operator's calls, ``bound_s``,
    times the calls found in the trace) / (the device time of the kernels
    those calls launched: ``pattern`` back to back on one stream). The
    profiler drops an event now and then in a long window, and a call with
    a dropped kernel is not found: None when fewer than ``MIN_FOUND`` of
    the program's ``counter`` of launched calls are found, or more than
    it."""
    calls = trace.match_calls(run.timeline.kernels, pattern)
    launched = run.counters.get(counter) or 0
    if not calls or not MIN_FOUND * launched <= len(calls) <= launched:
        print(f"roofline {counter}: {len(calls)} calls in the trace, "
              f"{launched} launched", file=sys.stderr)
        return None
    busy = sum(e - s for call in calls for _, s, e, _ in call)
    return 100.0 * bound_s * len(calls) / busy
