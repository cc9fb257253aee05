"""Grouped expert matmul: the wrapper of the Hopper kernel and its plain
versions.

:func:`grouped_matmul` is the kernel's own interface, ragged groups: rows
``x [R, D]``, weights ``w [E, D, F]``, int32 ``offsets [E]`` and
``counts [E]``; group e's rows ``offsets[e] .. offsets[e] + counts[e] - 1``
are multiplied by ``w[e]`` into ``out [R, F]``, and rows in no group are
left alone. :func:`moe_gmm` is the reference's dense-grouped function
(``repro/kernels/moe_gmm/ops.py``), ``x [E, C, D] @ w [E, D, F]``, on the
same kernel with offsets ``e * C`` and counts ``C``.

On a CUDA tensor each launches ``csrc/moe_gmm.cu`` (built on first use,
see :mod:`repro_torch.kernels.build`) or raises; there is no fallback. On
a CPU tensor, and only there, each computes its plain version
(:func:`grouped_matmul_plain`, :func:`moe_gmm_plain`). ``moe_gmm.launches``
counts the kernel's launches from both, and by instance:
``launches_wgmma`` (16-bit views TMA can read: wgmma with TMA loads),
``launches_mma`` (other 16-bit views: mma.sync with element loads) and
``launches_scalar`` (float32). The kernel masks the ragged edges itself,
so unlike the reference wrapper this one pads nothing.

On a shape-only tensor (meta or fake, :mod:`..shape_only`) it returns an
empty output and records :func:`gmm_cost`; the counts cannot be read
there, so the rows counted are ``rows=`` (the caller's expectation), by
default all of x's.

:func:`moe_gmm_bwd` is the VJP, ``csrc/moe_gmm.cu``'s second entry point:
``dx = dy @ w[e]^T`` on each group's rows (zeros on rows in no group) and
``dw[e] = x^T dy`` over the group's rows (zero for an empty group), with
:func:`grouped_matmul_bwd_plain` beside it and the same CPU/CUDA rule. On a
shape-only tensor it records :func:`gmm_bwd_cost` under ``moe_gmm_bwd`` and
allocates what the launch allocates. ``moe_gmm_bwd.launches`` counts its
calls on the card, ``kernel_launches`` its device launches (one a product
asked), and ``launches_wgmma`` / ``launches_scalar`` its calls by instance.
No fill precedes the kernel: it writes dx's rows in no group as zeros
itself.
Under grad on the card :func:`grouped_matmul` goes through
:class:`GroupedMatmulFn`: the forward on one kernel, the backward on the
other. The rows and the weights get gradients; the integer offsets and
counts, the routing, get none, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..plain_grad import needs_grad, plain_grads
from ..shape_only import record, shape_only
from ...spans import spanned

__all__ = ["grouped_matmul", "grouped_matmul_plain", "moe_gmm",
           "moe_gmm_plain", "GroupedMatmulFn", "gmm_cost", "moe_gmm_bwd",
           "grouped_matmul_bwd_plain", "gmm_bwd_cost"]

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


def gmm_cost(rows: int, d: int, f: int, hit: int,
             itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of a grouped matmul: 2 operations per (row, d,
    f); the rows of x read once, the output written once, the weights of
    the ``hit`` experts that received a row read once."""
    return 2 * rows * d * f, (rows * d + rows * f + hit * d * f) * itemsize


def gmm_bwd_cost(rows: int, d: int, f: int, hit: int, experts: int,
                 itemsize: int, need_dx: bool = True,
                 need_dw: bool = True) -> tuple[int, int]:
    """(operations, bytes) of the grouped matmul's VJP: 2 operations per
    (row, d, f) for each product asked; dy read once, and for dx the
    weights of the ``hit`` experts read and dx written, for dw x read and
    the ``experts`` weights' gradients written."""
    ops = 2 * rows * d * f * (int(need_dx) + int(need_dw))
    nbytes = rows * f
    if need_dx:
        nbytes += hit * d * f + rows * d
    if need_dw:
        nbytes += rows * d + experts * d * f
    return ops, nbytes * itemsize


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor, counts: torch.Tensor, *,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function as a loop over groups: each group's rows times
    its weights in f32, rounded to ``x.dtype``. Rows in no group keep what
    ``out`` holds (zeros when ``out`` is None)."""
    if out is None:
        out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                          device=x.device)
    for e, (o, c) in enumerate(zip(offsets.tolist(), counts.tolist())):
        if c > 0:
            out[o:o + c] = (x[o:o + c].float() @ w[e].float()).to(x.dtype)
    return out


def grouped_matmul_bwd_plain(x, w, offsets, counts, dy, *,
                             need_dx: bool = True, need_dw: bool = True):
    """The backward kernel's function in plain torch: autograd through
    :func:`grouped_matmul_plain` at dy. Returns ``(dx or None, dw or
    None)``."""
    return tuple(plain_grads(grouped_matmul_plain, (x, w), (need_dx, need_dw),
                             dy, offsets, counts))


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``repro/kernels/moe_gmm/ref.py``: an f32 einsum, cast to x.dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("moe_gmm").moe_gmm_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 8
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w, offsets, counts, out) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"grouped_matmul: unsupported dtype {x.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_matmul: x must be [R, D] and w [E, D, F], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"grouped_matmul: w is {w.dtype} on {w.device}, "
                         f"x is {x.dtype} on {x.device}")
    E = w.shape[0]
    for name, t in (("offsets", offsets), ("counts", counts)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (E,)
                or t.device != x.device or (E and t.stride(0) != 1)):
            raise ValueError(f"grouped_matmul: {name} must be contiguous "
                             f"int32 [{E}] on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("x", x), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"grouped_matmul: {name} must have a contiguous "
                             f"last dimension (strides {tuple(t.stride())})")
    shape = (x.shape[0], w.shape[2])
    if out is not None and (tuple(out.shape) != shape or out.dtype != x.dtype
                            or out.device != x.device or out.stride(-1) != 1):
        raise ValueError(f"grouped_matmul: out must be {shape} {x.dtype} on "
                         f"{x.device} with a contiguous last dimension")


def _wgmma_view(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether a 16-bit call goes to the wgmma instance: the rule of
    ``moe_gmm_launch`` (csrc/moe_gmm.cu), which TMA sets. Every pointer
    16-byte aligned; D, F and every row and expert stride multiples of 8
    elements."""
    return (all(t.data_ptr() % 16 == 0 for t in (x, w, out))
            and all(n % 8 == 0 for n in (x.shape[1], w.shape[2], x.stride(0),
                                         w.stride(0), w.stride(1),
                                         out.stride(0))))


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` under grad. ``kernel(x, w, offsets, counts)``
    computes the forward and ``backward(x, w, offsets, counts, dy, *,
    need_dx, need_dw)`` the VJP (on the card the two kernels' launches; a
    test may pass stand-ins); only the inputs are saved."""

    @staticmethod
    def forward(ctx, x, w, offsets, counts, kernel, backward):
        ctx.save_for_backward(x, w, offsets, counts)
        ctx.rows = getattr(kernel, "keywords", {}).get("rows")
        ctx.bwd = backward
        return kernel(x, w, offsets, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets, counts = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx, dw = ctx.bwd(x, w, offsets, counts, dy.contiguous(),
                         need_dx=need_dx, need_dw=need_dw, rows=ctx.rows)
        return dx, dw, None, None, None, None


@spanned("turnip.kernel.moe_gmm")
def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                   counts: torch.Tensor, *,
                   out: torch.Tensor | None = None,
                   rows: int | None = None) -> torch.Tensor:
    """``out[o:o+c] = x[o:o+c] @ w[e]`` for each group e with offset o and
    count c (int32, on x's device), accumulated in f32 and written in
    ``x.dtype``. The groups must be disjoint ranges of ``[0, R)``; rows in
    no group are left as they are in ``out`` (uninitialised on the card
    when ``out`` is None). Written into ``out`` when given, which autograd
    cannot follow. ``rows`` is the number of rows the groups hold, counted
    on shape-only tensors only."""
    _check(x, w, offsets, counts, out)
    if x.device.type == "cpu" and not shape_only(x):
        return grouped_matmul_plain(x, w, offsets, counts, out=out)
    if x.device.type != "cuda" and not shape_only(x):
        raise ValueError(f"grouped_matmul: no kernel for device {x.device}")
    kernel = _launch if rows is None else functools.partial(_launch,
                                                            rows=rows)
    if needs_grad(x, w):
        if out is not None:
            raise ValueError("grouped_matmul: out= under grad cannot be "
                             "differentiated")
        return GroupedMatmulFn.apply(x, w, offsets, counts, kernel,
                                     _launch_bwd)
    return kernel(x, w, offsets, counts, out)


def _launch(x, w, offsets, counts, out=None, *, rows=None) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors."""
    R, D = x.shape
    E, _, F = w.shape
    if out is None:
        out = torch.empty((R, F), dtype=x.dtype, device=x.device)
    if shape_only(x):
        record("moe_gmm", *gmm_cost(R if rows is None else rows, D, F, E,
                                    x.element_size()))
        return out
    if R == 0 or F == 0 or E == 0:
        return out
    err = _launcher()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), offsets.data_ptr(),
        counts.data_ptr(), R, D, F, E, x.stride(0), w.stride(0), w.stride(1),
        out.stride(0), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError {err}")
    instance = ("launches_scalar" if x.dtype == torch.float32 else
                "launches_wgmma" if _wgmma_view(x, w, out) else
                "launches_mma")
    with _count_lock:
        moe_gmm.launches += 1
        setattr(moe_gmm, instance, getattr(moe_gmm, instance) + 1)
    return out


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        from ..build import library
        fn = library("moe_gmm").moe_gmm_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 8
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                counts: torch.Tensor, dy: torch.Tensor, *,
                need_dx: bool = True, need_dw: bool = True):
    """The VJP of :func:`grouped_matmul` at ``dy [R, F]``: ``(dx, dw)``,
    each None when not asked, in x's dtype. dx's rows in no group are zero,
    an empty group's dw is zero; f32 sums."""
    _check(x, w, offsets, counts, None)
    R, F = x.shape[0], w.shape[2]
    if tuple(dy.shape) != (R, F) or dy.dtype != x.dtype \
            or dy.device != x.device:
        raise ValueError(f"moe_gmm_bwd: dy must be {(R, F)} {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if x.device.type == "cpu" and not shape_only(x):
        return grouped_matmul_bwd_plain(x, w, offsets, counts, dy,
                                        need_dx=need_dx, need_dw=need_dw)
    if x.device.type != "cuda" and not shape_only(x):
        raise ValueError(f"moe_gmm_bwd: no kernel for device {x.device}")
    return _launch_bwd(x, w, offsets, counts, dy, need_dx=need_dx,
                       need_dw=need_dw)


@spanned("turnip.kernel.moe_gmm_bwd")
def _launch_bwd(x, w, offsets, counts, dy, *, need_dx=True, need_dw=True,
                rows=None):
    """The backward's launches on checked CUDA tensors: one a product
    asked. dx is allocated empty (the kernel writes its rows in no group
    as zeros). ``rows`` as for :func:`grouped_matmul` (shape-only tensors
    only)."""
    R, D = x.shape
    E, _, F = w.shape
    dx = (torch.empty((R, D), dtype=x.dtype, device=x.device)
          if need_dx else None)
    dw = (torch.empty((E, D, F), dtype=w.dtype, device=w.device)
          if need_dw else None)
    if shape_only(x):
        record("moe_gmm_bwd", *gmm_bwd_cost(
            R if rows is None else rows, D, F, E, E, x.element_size(),
            need_dx, need_dw))
        return dx, dw
    if dy.stride(-1) != 1:
        raise ValueError("moe_gmm_bwd: dy must have a contiguous last "
                         "dimension")
    if not (need_dx or need_dw):
        return dx, dw
    if R == 0 or D == 0 or F == 0:
        for t in (dx, dw):             # sums over nothing
            if t is not None:
                t.zero_()
        return dx, dw
    err = _bwd_launcher()(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(),
        dx.data_ptr() if need_dx else None,
        dw.data_ptr() if need_dw else None, offsets.data_ptr(),
        counts.data_ptr(), R, D, F, E, x.stride(0), w.stride(0), w.stride(1),
        dy.stride(0), _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm_bwd kernel launch failed: cudaError "
                           f"{err}")
    # moe_gmm_bwd_launch's rule: the forward's with dy, dx and dw
    wgmma = (x.dtype != torch.float32 and _wgmma_view(x, w, dy)
             and all(t.data_ptr() % 16 == 0 for t in (dx, dw)
                     if t is not None))
    instance = "launches_wgmma" if wgmma else "launches_scalar"
    with _count_lock:
        moe_gmm_bwd.launches += 1
        moe_gmm_bwd.kernel_launches += int(need_dx) + int(need_dw)
        setattr(moe_gmm_bwd, instance, getattr(moe_gmm_bwd, instance) + 1)
    return dx, dw


moe_gmm_bwd.launches = 0
moe_gmm_bwd.kernel_launches = 0
moe_gmm_bwd.launches_wgmma = 0
moe_gmm_bwd.launches_scalar = 0


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[E, C, D]`` @ w ``[E, D, F]`` -> ``[E, C, F]``, one group per
    expert. The kernel keeps its own tiles, so the reference's block sizes
    have no counterpart here."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]:
        raise ValueError(f"moe_gmm: x must be [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    E, C, D = x.shape
    try:
        rows = x.view(E * C, D)
    except RuntimeError as e:
        raise ValueError(f"moe_gmm: x with strides {tuple(x.stride())} cannot "
                         f"be read as [E * C, D] rows without a copy") from e
    offsets = torch.arange(E, dtype=torch.int32, device=x.device) * C
    counts = torch.full((E,), C, dtype=torch.int32, device=x.device)
    if x.device.type == "cpu" and not shape_only(x):
        _check(rows, w, offsets, counts, None)
        return moe_gmm_plain(x, w)
    return grouped_matmul(rows, w, offsets, counts).view(E, C, w.shape[2])


moe_gmm.launches = 0
moe_gmm.launches_wgmma = 0
moe_gmm.launches_mma = 0
moe_gmm.launches_scalar = 0
