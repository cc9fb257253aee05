"""RMSNorm: the wrapper of the Hopper kernel and its plain PyTorch version.

:func:`rmsnorm` takes ``x`` of shape ``[..., D]`` and ``g`` of shape
``[D]``. On a CUDA tensor it launches ``csrc/rmsnorm.cu`` (built on first
use, see :mod:`repro_torch.kernels.build`) or raises; there is no fallback.
On a CPU tensor, and only there, it computes :func:`rmsnorm_plain`.
``rmsnorm.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["rmsnorm", "rmsnorm_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_count_lock = threading.Lock()
_fn = None


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: f32 mean of squares, f32
    scale, cast back to ``x.dtype`` (``repro/kernels/rmsnorm/ref.py``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


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
