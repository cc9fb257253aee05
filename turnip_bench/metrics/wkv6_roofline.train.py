"""wkv6's share of its roofline in the training step: the least time of
the window's forward calls (``costs/wkv6_fwd.py``: r, k, v, lw read once,
y written once; the products at the float32-accurate tensor-core rate,
the rest at the float32 rate) over the device time of the kernels each
call launched, in percent. A call is a ``turnip.kernel.wkv6`` span of the
program, in the forward or the checkpoint's recompute, in which all of its
device launches are in the trace (a span short of one lost it to the
profiler); no kernel is found by its name."""
import sys

from .. import spans
from ..costs import wkv6_fwd
from ._read import BYTES_F32, MIN_FOUND

spans.install()

COUNTERS = {"wkv6": "repro_torch.kernels.rwkv6.ops:wkv6.launches"}
SPAN = "turnip.kernel.wkv6"
KERNELS = 3                # a call's device launches (group states, the
                           # pass across groups, the outputs)
CHUNK = 32                 # the model's WKV chunk (models/rwkv.py)


def calls(reading) -> list[list]:
    """The forward calls in the trace, each the list of its kernel rows."""
    by_span: dict[int, list] = {}
    for r in reading.rows:
        if r.label in (SPAN, SPAN + ":recompute") and \
                not r.name.startswith(("Memcpy", "Memset")):
            by_span.setdefault(r.span, []).append(r)
    return list(by_span.values())


def read(run):
    arch = run.cell.arch
    reading = spans.of(run)
    if arch["family"] != "rwkv" or reading is None:
        return None
    seen = calls(reading)
    found = [rows for rows in seen if len(rows) == KERNELS]
    launched = run.counters.get("wkv6") or 0
    if not found or not MIN_FOUND * launched <= len(found) <= launched:
        print(f"roofline wkv6: {len(found)} whole calls in the trace "
              f"({len(seen)} spans with a kernel), {launched} launched",
              file=sys.stderr)
        return None
    P = arch["rwkv_headdim"]
    seqs = run.lengths[0]                  # every step has one shape
    bound, binds = wkv6_fwd.wkv6_bound_s(len(seqs), seqs[0],
                                         arch["d_model"] // P, P,
                                         min(CHUNK, seqs[0]), BYTES_F32)
    busy = sum(r.end - r.start for rows in found for r in rows)
    print(f"roofline wkv6: {len(found)} of {launched} calls whole "
          f"({len(seen) - len(found)} spans short of a kernel), "
          f"{busy / len(found)!r} s a call, bound {bound!r} s by the "
          f"{binds}", file=sys.stderr)
    return 100.0 * bound * len(found) / busy
