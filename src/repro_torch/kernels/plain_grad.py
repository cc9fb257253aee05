"""Gradients through a kernel that has no backward kernel yet.

The grouped matmul, the SSD scan and WKV6 run their forward on the card's
hand-written kernel. Their ``autograd.Function``s (one in each kernel's
``ops.py``) save only the inputs, and their backward recomputes the
kernel's plain version and differentiates it: :func:`plain_grads`. The
gradient is then exactly the plain function's, which the CPU tests hold
against ``jax.grad`` of the reference. A backward kernel can later take
its place without touching a caller (ROADMAP B5).
"""
from __future__ import annotations

import torch

__all__ = ["needs_grad", "plain_grads"]


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_grads(plain, inputs, needs, dy: torch.Tensor, *args, **kw):
    """The vector-Jacobian product of ``plain(*inputs, *args, **kw)`` at
    ``dy``: one gradient for each of ``inputs`` whose ``needs`` flag is
    set, ``None`` for the others. ``plain`` is recomputed under grad."""
    leaves = [t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t.requires_grad]
    if not wanted:
        return [None] * len(leaves)
    with torch.enable_grad():
        y = plain(*leaves, *args, **kw)
    grads = iter(torch.autograd.grad(y, wanted, dy))
    return [next(grads) if t.requires_grad else None for t in leaves]
