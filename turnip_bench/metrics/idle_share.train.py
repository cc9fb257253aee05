"""Percent of the traced window in which no kernel, copy or memset ran on
the card."""
from .. import trace


def read(run):
    tl = run.timeline
    if not tl.device():
        return None
    busy = trace.union_length((s, e) for _, s, e, _ in tl.device())
    return 100.0 * (1.0 - busy / tl.window_s)
