"""Named spans of the port's work, for ``torch.profiler``.

``span(name)`` marks a stretch of host code with a profiler range
(``torch.profiler.record_function``), so that a trace can say which part
of the program launched each kernel and copy: a kernel's correlation id
leads to its host launch, and the launch lies inside the innermost span
open on its thread. A backward node carries the sequence number of the
forward operator that made it, so the backward's kernels lead back to the
forward's spans too. With no profiler on, ``span`` hands back one shared
no-op context after a single flag check: nothing is allocated and no
profiler range is entered.

Names are fixed strings, one per place in the program (no layer index), so
that a trace holds a small set of them; ``NAMES`` lists every one.
"""
from __future__ import annotations

import contextlib
import functools

import torch.autograd.profiler as _profiler

__all__ = ["NAMES", "span", "spanned"]

NAMES = (
    # train/step.py
    "turnip.step.forward",        # the loss: the model's forward
    "turnip.step.backward",       # torch.autograd.grad of the loss
    "turnip.step.optimizer",      # the gradient norm, the update, applying it
    # models/lm.py
    "turnip.layer",               # one layer's body (forward and recompute)
    "turnip.lm.head",             # the final norm, the unembedding, the NLL
    # models/rwkv.py
    "turnip.rwkv.time_mix",       # an RWKV block's time-mix half
    "turnip.rwkv.channel_mix",    # its channel-mix half
    "turnip.rwkv.mix",            # a half's token shift and mixes
    "turnip.rwkv.wkv",            # the casts around the wkv6 call, and it
    # models/lora.py
    "turnip.lora.merge",          # one adapted weight's merge
    # models/offload.py
    "turnip.offload.pack",        # a layer input's copy to host memory
    "turnip.offload.reload",      # its copy back to the card
    "turnip.offload.wait",        # the compute stream's wait on a reload
    # kernels/*/ops.py: a hand-written op's calls, forward and backward
    "turnip.kernel.rmsnorm",
    "turnip.kernel.rmsnorm_bwd",
    "turnip.kernel.flash_attention",
    "turnip.kernel.flash_attention_bwd",
    "turnip.kernel.moe_gmm",
    "turnip.kernel.moe_gmm_bwd",
    "turnip.kernel.ssd_scan",
    "turnip.kernel.ssd_scan_bwd",
    "turnip.kernel.wkv6",
    "turnip.kernel.wkv6_bwd",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks its body as ``name`` (one of ``NAMES``) while a
    profiler is on, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
