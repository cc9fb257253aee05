"""The plain backward: autograd through a kernel's plain version.

The grouped matmul, the SSD scan and WKV6 have backward kernels
(``moe_gmm_bwd``, ``ssd_scan_bwd``, ``wkv6_bwd``). Each kernel's plain
backward beside it (``grouped_matmul_bwd_plain``, ``ssd_scan_bwd_plain``,
``wkv6_bwd_plain``) is :func:`plain_grads` of its plain forward: what the
backward wrappers compute on a CPU tensor, and what the card's tests and
``chip_smoke.py`` hold the backward kernels against. Nothing on the card's
training path calls it: under grad on a CUDA or a shape-only tensor the
``autograd.Function``s launch the backward kernels or record them.
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
