"""``remat='offload'``: each layer's input to pinned host memory.

The reference's ``'offload'`` policy (``repro/models/lm.py:86-91``) saves
nothing of a layer on the device but its input, the scan carry it names
``"residual"``, and asks XLA to keep that on pinned host memory. The port
does the same inside PyTorch: the layer body runs under a non-reentrant
``torch.utils.checkpoint`` (recomputed in the backward) and the one tensor
the checkpoint saves, the layer's input, goes through this module's
saved-tensor hooks:

* pack: a device → host copy into pinned memory on the d2h copy stream,
  after an event recorded on the compute stream where the input was made.
  ``record_stream`` keeps the input's device memory from being reused until
  the copy has read it; the input itself is freed as soon as the forward no
  longer needs it.
* unpack (the layer's backward): the compute stream waits on the reload's
  event, and the reload of the layer before it is issued at once on the h2d
  copy stream, so that it overlaps this layer's recompute and backward. A
  reload allocates its device tensor on the h2d stream and
  ``record_stream``\\ s it on the compute stream.

The copy streams are the runtime's own (``core/executor.py::stream_for``,
engines ``"d2h"`` and ``"h2d"``), the pattern of ROADMAP C3
(``serve/kv_cache.py``). On the CPU the "host" copy is a clone: the same
control flow, no streams.

The object lives as long as the autograd graph that holds its hooks, so
its pinned host slots go with the graph. ``moved`` counts the bytes that
every offload of the process moved out and back in since
:func:`reset_moved`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.executor import stream_for

__all__ = ["ResidualOffload", "moved", "reset_moved"]

moved = {"offloaded": 0, "reloaded": 0}
_moved_lock = threading.Lock()


def reset_moved() -> None:
    """Zero the process's offloaded and reloaded byte counts."""
    with _moved_lock:
        moved.update(offloaded=0, reloaded=0)


def _count(kind: str, nbytes: int) -> None:
    with _moved_lock:
        moved[kind] += nbytes


class ResidualOffload:
    """Saved-tensor hooks that offload each checkpointed layer's input.

    One object serves one forward and its backward."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.d2h = stream_for(device, "d2h", 0, 0) if self.cuda else None
        self.h2d = stream_for(device, "h2d", 0, 0) if self.cuda else None
        self._slots: list[dict] = []
        self._target: torch.Tensor | None = None

    @contextlib.contextmanager
    def layer(self, h: torch.Tensor):
        """Offload ``h`` if it is saved for the backward inside this block
        (the checkpoint of the layer it feeds); anything else saved here is
        kept as it is."""
        self._target = h
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield
        finally:
            self._target = None

    def _pack(self, t: torch.Tensor):
        h = self._target
        if (h is None or t.numel() == 0 or t.data_ptr() != h.data_ptr()
                or t.shape != h.shape or t.dtype != h.dtype):
            return ("keep", t)
        nbytes = t.numel() * t.element_size()
        if not self.cuda:
            self._slots.append({"host": t.detach().clone(), "dev": None})
        else:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            made = torch.cuda.Event()
            made.record(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.d2h):
                self.d2h.wait_event(made)
                host.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.d2h)
            t.record_stream(self.d2h)
            self._slots.append({"host": host, "d2h": done, "dev": None,
                                "h2d": None})
        _count("offloaded", nbytes)
        return ("slot", len(self._slots) - 1)

    def _reload(self, i: int) -> None:
        s = self._slots[i]
        host = s["host"]
        _count("reloaded", host.numel() * host.element_size())
        if not self.cuda:
            s["dev"] = host.clone()
            return
        with torch.cuda.stream(self.h2d):
            self.h2d.wait_event(s["d2h"])
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.h2d)
        dev.record_stream(torch.cuda.current_stream(self.device))
        s["dev"], s["h2d"] = dev, ev

    def _unpack(self, packed):
        kind, val = packed
        if kind == "keep":
            return val
        s = self._slots[val]
        if s["dev"] is None:
            self._reload(val)
        dev, s["dev"] = s["dev"], None
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(s["h2d"])
        # the backward walks the layers in reverse: issue the next reload
        if val > 0 and self._slots[val - 1]["dev"] is None:
            self._reload(val - 1)
        return dev
