"""wkv6_bwd's share of its roofline in the training step: the least time
of the window's calls (``costs/wkv6.py``: r, k, v, lw and dy read once,
the gradients written once; the products at the float32-accurate
tensor-core rate, the rest at the float32 rate) over the device time of
the six kernels each call launches, in percent."""
from ..costs import wkv6
from ._read import BYTES_F32, roofline_share

COUNTERS = {"wkv6_bwd": "repro_torch.kernels.rwkv6.ops:wkv6_bwd.launches"}
PATTERN = ["wkv6_states", "wkv6_carry", "wkv6_bwd_gstates",
           "wkv6_bwd_carry", "wkv6_bwd_chunk", "wkv6_bwd_du"]
CHUNK = 32                 # the model's WKV chunk (models/rwkv.py)


def read(run):
    arch = run.cell.arch
    if arch["family"] != "rwkv":
        return None
    P = arch["rwkv_headdim"]
    seqs = run.lengths[0]                  # every step has one shape
    bound = wkv6.wkv6_bwd_bound_s(len(seqs), seqs[0], arch["d_model"] // P,
                                  P, min(CHUNK, seqs[0]), BYTES_F32)
    return roofline_share(run, PATTERN, "wkv6_bwd", bound)
