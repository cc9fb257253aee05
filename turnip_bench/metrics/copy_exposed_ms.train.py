"""Milliseconds a step in which a copy between host and card (Memcpy DtoH
or HtoD: the activation offload and its reloads) runs and no kernel does:
the copies the step waits for."""
from .. import trace


def read(run):
    tl = run.timeline
    copies = [(s, e) for name, s, e, _ in tl.copies
              if name.startswith("Memcpy") and ("DtoH" in name or "HtoD" in name)]
    if not copies or not run.units:
        return None
    kernels = [(s, e) for _, s, e, _ in tl.kernels]
    return 1e3 * trace.subtract_length(copies, kernels) / run.units
