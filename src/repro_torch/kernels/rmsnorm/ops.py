"""RMSNorm: the wrappers of the Hopper kernels and their plain versions.

:func:`rmsnorm` takes ``x`` of shape ``[..., D]`` and ``g`` of shape
``[D]``. On a CUDA tensor it launches ``csrc/rmsnorm.cu`` (built on first
use, see :mod:`repro_torch.kernels.build`) or raises; there is no fallback.
On a CPU tensor, and only there, it computes :func:`rmsnorm_plain`.
``rmsnorm.launches`` counts the kernel's launches.

:func:`rmsnorm_bwd` is the VJP (dx, and dγ when asked), the same file's
second entry point, with :func:`rmsnorm_bwd_plain` beside it and the same
CPU/CUDA rule; ``rmsnorm_bwd.launches`` counts its calls on the card and
``rmsnorm_bwd.kernel_launches`` its device launches (one row pass, plus
one reduction launch when dγ is asked). :class:`RMSNormFn`
is the ``torch.autograd.Function`` of the pair: the model differentiates
through it on both devices.
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["rmsnorm", "rmsnorm_plain", "rmsnorm_bwd", "rmsnorm_bwd_plain",
           "RMSNormFn"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None
# row blocks of the backward when dγ is asked: each writes one f32 row of
# the workspace that the reduction launch sums (4 blocks an SM on an H100)
DG_PARTS = 528


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: float32, or float64 for float64 inputs (the
    autograd checks run in float64)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: f32 mean of squares, f32
    scale, cast back to ``x.dtype`` (``repro/kernels/rmsnorm/ref.py``)."""
    xf = x.to(_acc(x.dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.to(xf.dtype)).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, *,
                      eps: float = 1e-6, need_dg: bool = True):
    """The backward kernel's arithmetic in plain torch: with
    r = rsqrt(mean(x²) + eps), dx = r·(dy∘g) − x·(r³/D)·Σ(dy∘g∘x) and
    dγ = Σ_rows dy∘x∘r, in f32 (f64 for f64 inputs), each rounded once to
    its input's type. Returns ``(dx, dγ or None)``."""
    D = x.shape[-1]
    xf = x.to(_acc(x.dtype))
    dyf = dy.to(xf.dtype)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyg = dyf * g.to(xf.dtype)
    s = (dyg * xf).sum(dim=-1, keepdim=True)
    dx = (r * dyg - xf * (r ** 3 / D * s)).to(x.dtype)
    dg = None
    if need_dg:
        dg = (dyf * xf * r).reshape(-1, D).sum(dim=0).to(g.dtype)
    return dx, dg


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        from ..build import library
        fn = library("rmsnorm").rmsnorm_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int64,
                                                ctypes.c_int]
                       + [ctypes.c_int64] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("rmsnorm").rmsnorm_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as ``[rows, D]`` without a copy; raises when that needs one."""
    if t.dim() == 0 or t.stride(-1) != 1:
        raise ValueError(f"rmsnorm: {name} must have a contiguous last "
                         f"dimension (strides {tuple(t.stride())})")
    try:
        return t.view(-1, t.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"rmsnorm: {name} with strides {tuple(t.stride())} "
                         f"cannot be read as rows without a copy") from e


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2, -1) + eps) * g, written into ``out`` when
    given (same shape, dtype and device as ``x``)."""
    D = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if g.dtype != x.dtype or tuple(g.shape) != (D,) or g.device != x.device:
        raise ValueError(f"rmsnorm: g must be [{D}] {x.dtype} on {x.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"rmsnorm: out must be {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    if x.device.type == "cpu":
        y = rmsnorm_plain(x, g, eps=eps)
        if out is None:
            return y
        return out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    x2, o2 = _rows(x, "x"), _rows(out, "out")
    if g.stride(0) != 1:
        raise ValueError("rmsnorm: g must be contiguous")
    if x2.shape[0] == 0:
        return out
    err = _launcher()(x2.data_ptr(), g.data_ptr(), o2.data_ptr(),
                      x2.shape[0], D, x2.stride(0), o2.stride(0), float(eps),
                      _DTYPE_CODE[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    with _count_lock:
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6, need_dg: bool = True,
                out: torch.Tensor | None = None):
    """The VJP of :func:`rmsnorm`: ``(dx, dγ or None)``; dx written into
    ``out`` when given (x's shape and dtype). ``need_dg=False`` skips dγ
    (a frozen gain)."""
    D = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm_bwd: unsupported dtype {x.dtype}")
    if (g.dtype != x.dtype or tuple(g.shape) != (D,) or g.device != x.device
            or dy.shape != x.shape or dy.dtype != x.dtype
            or dy.device != x.device):
        raise ValueError(f"rmsnorm_bwd: g must be [{D}] and dy {tuple(x.shape)}"
                         f", both {x.dtype} on {x.device}; got g "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}, dy "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"rmsnorm_bwd: out must be {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if x.device.type == "cpu":
        dx, dg = rmsnorm_bwd_plain(x, g, dy, eps=eps, need_dg=need_dg)
        return (dx if out is None else out.copy_(dx)), dg
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: no kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    x2, d2, o2 = _rows(x, "x"), _rows(dy, "dy"), _rows(out, "out")
    if g.stride(0) != 1:
        raise ValueError("rmsnorm_bwd: g must be contiguous")
    n_rows = x2.shape[0]
    dg = torch.zeros_like(g) if need_dg else None
    if n_rows == 0:
        return out, dg
    parts = min(n_rows, DG_PARTS)
    ws = (torch.empty((parts, D), dtype=torch.float32, device=x.device)
          if need_dg else None)
    err = _bwd_launcher()(
        x2.data_ptr(), g.data_ptr(), d2.data_ptr(), o2.data_ptr(),
        ws.data_ptr() if need_dg else None, dg.data_ptr() if need_dg else None,
        parts, n_rows, D, x2.stride(0), d2.stride(0), o2.stride(0),
        float(eps), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: cudaError {err}")
    with _count_lock:
        rmsnorm_bwd.launches += 1
        rmsnorm_bwd.kernel_launches += 2 if need_dg else 1
    return out, dg


rmsnorm_bwd.launches = 0
rmsnorm_bwd.kernel_launches = 0


class RMSNormFn(torch.autograd.Function):
    """y = rmsnorm(x, g) with its VJP: the kernels on CUDA, the plain
    versions on the CPU. r is recomputed from x in the backward; nothing
    but x and g is saved. dγ is computed only when g needs a gradient."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_plain(x, g, eps=eps)
        return rmsnorm(x, g, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        need_dx, need_dg = ctx.needs_input_grad[:2]
        if not (need_dx or need_dg):
            return None, None, None
        if x.device.type == "cpu":
            dx, dg = rmsnorm_bwd_plain(x, g, dy, eps=ctx.eps, need_dg=need_dg)
        else:
            dx, dg = rmsnorm_bwd(x, g, dy.contiguous(), eps=ctx.eps,
                                 need_dg=need_dg)
        return (dx if need_dx else None), dg, None
