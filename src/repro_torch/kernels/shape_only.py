"""Shape-only tensors: meta tensors, and fake tensors on any device.

Given one, a kernel wrapper computes nothing and launches nothing: it
returns empty outputs of the right shapes and reports its kernel's work
(operations and bytes, from the counts beside each kernel's ``ops.py``) to
the active recorder, the dry run's (``launch/dryrun.py``). A fake CUDA
tensor reports ``device.type == "cuda"``, so each wrapper asks
:func:`shape_only` before it looks at the device. On a real tensor
nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["shape_only", "record", "recording"]

_recorder: Callable[[str, int, int], None] | None = None


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds shapes and no data."""
    return t.device.type == "meta" or isinstance(t, FakeTensor)


def record(name: str, ops: int, nbytes: int) -> None:
    """Report one kernel call's operations and bytes moved."""
    if _recorder is not None:
        _recorder(name, int(ops), int(nbytes))


@contextlib.contextmanager
def recording(fn: Callable[[str, int, int], None]):
    """Send every :func:`record` to ``fn`` inside the block."""
    global _recorder
    prev, _recorder = _recorder, fn
    try:
        yield
    finally:
        _recorder = prev
