"""Which torch device the port runs on.

Every entry point of the port runs on the card unless the caller asks for
the CPU: ``device=None`` means ``"cuda"``, and asking for CUDA on a machine
without it raises instead of quietly running on the CPU. ``"meta"`` holds
shapes only: the dry run (``launch/dryrun.py``) builds its models there.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to CUDA. Raises
    ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
