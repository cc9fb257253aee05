"""RWKV-6 chunked WKV: the wrapper of the Hopper kernel and its plain
version.

:func:`wkv6` takes the reference's layout (``repro/kernels/rwkv6/ops.py``):
``r``, ``k``, ``v`` and ``lw`` (the log decay, <= 0) ``[B, S, H, P]`` and
the bonus ``u [H, P]``, and returns ``y [B, S, H, P]`` in ``r``'s dtype. On
a CUDA tensor it launches ``csrc/wkv6.cu`` (built on first use, see
:mod:`repro_torch.kernels.build`) or raises; there is no fallback. On a CPU
tensor, and only there, it computes :func:`wkv6_plain`.
``wkv6.launches`` counts the wrapper's calls that launched the kernel, one
per call; ``wkv6.kernel_launches`` counts the device launches, three per
call (group states, the pass across groups, the outputs), which share an
f32 workspace of ``[B, H, ng, P, P]`` states and ``[B, H, ng, P]`` decays,
``ng = ceil(ceil(S / chunk) / GROUP)``, that the wrapper allocates on the
caller's stream.

The recurrence starts from a zero state and returns none, as the TPU
kernel does; the model's decode step, which carries a state, uses its own
recurrence (``models/rwkv.py::wkv6_chunked``). The kernel masks the ragged
last chunk itself (as zero rows: lw = 0 and k = v = 0 leave the state
unchanged), so unlike the reference wrapper this one pads nothing.

:func:`wkv6_bwd` is the VJP (dr, dk, dv, dlw, du), the same file's second
entry point, with :func:`wkv6_bwd_plain` beside it and the same CPU/CUDA
rule. It recomputes the state entering every chunk with the forward's
passes 1-2 (groups of one chunk), then four launches: each chunk's state
gradient, their reverse carry, the per-chunk gradients (dlw as the reverse
cumulative sums of the decay terms, every exponent a non-positive
difference of cumulative log decays) and du's fixed-order sum, through an
f32 workspace (:func:`wkv6_bwd_work`) the wrapper allocates.
``wkv6_bwd.launches`` counts its calls on the card and ``kernel_launches``
its device launches, six a call. On a shape-only tensor it records
:func:`wkv6_bwd_cost` under ``wkv6_bwd`` and allocates the outputs and the
workspace. Under grad on the card :func:`wkv6` goes through
:class:`WKV6Fn`: the forward on one kernel, the backward on the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..plain_grad import needs_grad, plain_grads
from ..shape_only import record, shape_only
from ...spans import spanned

__all__ = ["wkv6", "wkv6_plain", "WKV6Fn", "wkv6_ops", "wkv6_cost",
           "wkv6_bwd", "wkv6_bwd_plain", "wkv6_bwd_ops", "wkv6_bwd_cost",
           "wkv6_bwd_work"]

MAX_P = 64                 # what csrc/wkv6.cu is built for
MAX_CHUNK = 64
GROUP = 16                 # chunks a workspace state covers
KERNELS_PER_CALL = 3       # group states, state pass, outputs
BWD_KERNELS_PER_CALL = 6   # states, pass, state gradients, reverse pass,
                           # per-chunk gradients, du
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # as csrc/ instantiates
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


def wkv6_ops(B, S, H, P, chunk) -> int:
    """WKV6's operations: per chunk of n rows, per (b, h), the strict lower
    triangle's A terms (n(n-1)/2 x P, each two products, a sum and an
    exponential), A v (n(n-1)/2 x P multiply-adds), the bonus (5 n P), the
    incoming-state term and the state update (n x P x P multiply-adds
    each, and 2 n P for their decay factors)."""
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri = n * (n - 1) // 2
        ops += 4 * tri * P + 2 * tri * P + 5 * n * P \
            + 2 * 2 * n * P * P + 2 * 2 * n * P
    return ops * B * H


def wkv6_cost(B, S, H, P, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): r, k, v, lw read once and y written once."""
    return wkv6_ops(B, S, H, P, chunk), 5 * B * S * H * P * itemsize


def wkv6_bwd_ops(B, S, H, P, chunk) -> int:
    """WKV6's VJP's operations: per chunk of n rows, per (b, h), the strict
    lower triangle's pair terms three times (A, dr, dk: n(n-1)/2 x P, each
    two products, a sum and an exponential), dA and A^T dy (n(n+1)/2 x P
    multiply-adds each), the bonus terms (9 n P), five n x P x P products
    (the recomputed state, its gradient, S dy, D v, k' D), the two carries
    (2 x P x P) and dlw's sums (4 n P)."""
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri, tri1 = n * (n - 1) // 2, n * (n + 1) // 2
        ops += 3 * 4 * tri * P + 2 * 2 * tri1 * P + 9 * n * P \
            + 2 * 5 * n * P * P + 2 * 2 * P * P + 4 * n * P
    return ops * B * H


def wkv6_bwd_cost(B, S, H, P, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): r, k, v, lw and dy read once, dr, dk, dv and
    dlw written once."""
    return wkv6_bwd_ops(B, S, H, P, chunk), 9 * B * S * H * P * itemsize


def wkv6_bwd_work(B, S, H, P, chunk) -> int:
    """Floats of the backward's workspace (``wkv6_bwd_launch``): the states
    entering each chunk and their decays [B, H, nc, P, P + 1], the state
    gradients [B, H, nc, P, P] and du's partials [B, nc, H, P]."""
    nc = -(-S // min(chunk, S))
    return B * H * nc * (2 * P * P + 2 * P)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, *,
               chunk: int = 32) -> torch.Tensor:
    """The Pallas body (``_wkv6_kernel``) chunk by chunk in plain torch, all
    (batch, head) pairs at once: f32 throughout, S zero-padded to a
    multiple of ``c = min(chunk, S)``, y rounded to ``r.dtype``. The
    ``[c, c, P]`` exponent tensor is formed per chunk, as on the TPU."""
    B, S, H, P = r.shape
    if S == 0:
        return torch.empty_like(r)
    c = min(chunk, S)
    pad = (-S) % c

    def padded(t):                          # zeros past S, in f32
        return torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))

    rf, kf, vf, lwf = padded(r), padded(k), padded(v), padded(lw)
    uf = u.float()
    state = torch.zeros(B, H, P, P, dtype=torch.float32, device=r.device)
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                        diagonal=-1)
    ys = []
    for i0 in range(0, S + pad, c):
        rj, kj, vj, lwj = (t[:, i0:i0 + c] for t in (rf, kf, vf, lwf))
        lcw = torch.cumsum(lwj, dim=1)                       # [B,c,H,P]
        prev = lcw - lwj
        diff = prev[:, :, None] - lcw[:, None]               # [B,t,s,H,P]
        # mask the exponent's input: s >= t differences are positive
        E = torch.exp(diff.masked_fill(~strict[None, :, :, None, None],
                                       -1e30))
        A = torch.einsum("bthp,btshp,bshp->bths", rj, E, kj)
        y = torch.einsum("bths,bshq->bthq", A, vj)
        du = torch.einsum("bthp,hp,bthp->bth", rj, uf, kj)
        y = y + du[..., None] * vj
        y = y + torch.einsum("bthp,bhpq->bthq", rj * torch.exp(prev), state)
        ys.append(y)
        tailw = torch.exp(lcw[:, -1:] - lcw)                 # [B,c,H,P] <= 1
        upd = torch.einsum("bshp,bshq->bhpq", kj * tailw, vj)
        state = torch.exp(lcw[:, -1])[..., None] * state + upd
    return torch.cat(ys, dim=1)[:, :S].to(r.dtype)


def wkv6_bwd_plain(r, k, v, lw, u, dy, *, chunk: int = 32):
    """The backward kernel's function in plain torch: autograd through
    :func:`wkv6_plain` at dy. Returns ``(dr, dk, dv, dlw, du)``."""
    return tuple(plain_grads(wkv6_plain, (r, k, v, lw, u), (True,) * 5, dy,
                             chunk=chunk))


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("wkv6").wkv6_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(r, k, v, lw, u, chunk) -> None:
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv6: unsupported dtype {r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be [B, S, H, P], got "
                         f"{tuple(r.shape)}")
    H, P = r.shape[2], r.shape[3]
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("lw", lw, r.shape), ("u", u, (H, P))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on "
                             f"{r.device}")
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"wkv6: chunk must be an int >= 1, got {chunk!r}")


class WKV6Fn(torch.autograd.Function):
    """:func:`wkv6` under grad. ``kernel(r, k, v, lw, u, chunk)`` computes
    the forward and ``backward(r, k, v, lw, u, dy, chunk)`` all five
    gradients (on the card the two kernels' launches; a test may pass
    stand-ins); only the inputs are saved, and an input that needs no
    gradient gets None."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, chunk, kernel, backward):
        ctx.save_for_backward(r, k, v, lw, u)
        ctx.chunk = chunk
        ctx.bwd = backward
        return kernel(r, k, v, lw, u, chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ctx.bwd(*ctx.saved_tensors, dy.contiguous(), ctx.chunk)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad[:5])), None, None, None)


@spanned("turnip.kernel.wkv6")
def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, *, chunk: int = 32
         ) -> torch.Tensor:
    """The WKV6 recurrence per head, from a zero state, in chunks of
    ``min(chunk, S)``: ``S_t = diag(e^{lw_t}) S_{t-1} + k_t^T v_t`` and
    ``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``. Returns ``[B, S, H, P]``
    in ``r.dtype``."""
    _check(r, k, v, lw, u, chunk)
    if r.device.type == "cpu" and not shape_only(r):
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if r.device.type != "cuda" and not shape_only(r):
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    if needs_grad(r, k, v, lw, u):
        return WKV6Fn.apply(r, k, v, lw, u, chunk, _launch, _launch_bwd)
    return _launch(r, k, v, lw, u, chunk)


def _launch(r, k, v, lw, u, chunk) -> torch.Tensor:
    """The kernel's three launches on checked CUDA tensors."""
    B, S, H, P = r.shape
    if shape_only(r):
        record("wkv6", *wkv6_cost(B, S, H, P, min(int(chunk), S),
                                  r.element_size()))
        return torch.empty_like(r)
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.dtype != r.dtype:
            raise ValueError(f"wkv6: {name} is {t.dtype}, r {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        if not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous (strides "
                             f"{tuple(t.stride())})")
    if P > MAX_P:
        raise ValueError(f"wkv6: the kernel takes P <= {MAX_P}, got {P}")
    c = min(int(chunk), S)
    if c > MAX_CHUNK:
        raise ValueError(f"wkv6: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"got {c}")
    y = torch.empty_like(r)
    if y.numel() == 0:
        return y
    uf = u.to(torch.float32).contiguous()
    nc = -(-S // c)
    ng = -(-nc // GROUP)
    work = torch.empty(B * H * ng * (P * P + P), dtype=torch.float32,
                       device=r.device)
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lw.data_ptr(), uf.data_ptr(), y.data_ptr(),
                      work.data_ptr(), B, S, H, P, c, GROUP,
                      _DTYPE_CODE[r.dtype],
                      torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {err}")
    with _count_lock:
        wkv6.launches += 1
        wkv6.kernel_launches += KERNELS_PER_CALL
    return y


wkv6.launches = 0
wkv6.kernel_launches = 0


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        from ..build import library
        fn = library("wkv6").wkv6_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             lw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
             chunk: int = 32):
    """The VJP of :func:`wkv6` at ``dy`` (``r``'s shape and dtype):
    ``(dr, dk, dv, dlw, du)``, each in its input's dtype."""
    _check(r, k, v, lw, u, chunk)
    if tuple(dy.shape) != tuple(r.shape) or dy.device != r.device:
        raise ValueError(f"wkv6_bwd: dy must be {tuple(r.shape)} on "
                         f"{r.device}, got {tuple(dy.shape)} on {dy.device}")
    if r.device.type == "cpu" and not shape_only(r):
        return wkv6_bwd_plain(r, k, v, lw, u, dy, chunk=chunk)
    if r.device.type != "cuda" and not shape_only(r):
        raise ValueError(f"wkv6_bwd: no kernel for device {r.device}")
    return _launch_bwd(r, k, v, lw, u, dy, chunk)


@spanned("turnip.kernel.wkv6_bwd")
def _launch_bwd(r, k, v, lw, u, dy, chunk):
    """The backward's six launches on checked CUDA tensors."""
    B, S, H, P = r.shape
    c = min(int(chunk), S) if S else 1
    grads = tuple(torch.empty_like(t) for t in (r, k, v, lw)) \
        + (torch.empty(H, P, dtype=torch.float32, device=r.device),)
    work = torch.empty(wkv6_bwd_work(B, S, H, P, c), dtype=torch.float32,
                       device=r.device)
    if shape_only(r):
        record("wkv6_bwd", *wkv6_bwd_cost(B, S, H, P, c, r.element_size()))
        return (*grads[:4], grads[4].to(u.dtype))
    for name, t in (("k", k), ("v", v), ("lw", lw), ("dy", dy)):
        if t.dtype != r.dtype:
            raise ValueError(f"wkv6_bwd: {name} is {t.dtype}, r {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"wkv6_bwd: {name} must be contiguous (strides "
                             f"{tuple(t.stride())})")
    if P > MAX_P:
        raise ValueError(f"wkv6_bwd: the kernel takes P <= {MAX_P}, got {P}")
    if c > MAX_CHUNK:
        raise ValueError(f"wkv6_bwd: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"got {c}")
    dr, dk, dv, dlw, du = grads
    if dr.numel() == 0:
        return dr, dk, dv, dlw, du.zero_().to(u.dtype)
    uf = u.to(torch.float32).contiguous()
    err = _bwd_launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lw.data_ptr(), uf.data_ptr(), dy.data_ptr(),
                          dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          dlw.data_ptr(), du.data_ptr(), work.data_ptr(),
                          B, S, H, P, c, _DTYPE_CODE[r.dtype],
                          torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: cudaError {err}")
    with _count_lock:
        wkv6_bwd.launches += 1
        wkv6_bwd.kernel_launches += BWD_KERNELS_PER_CALL
    return dr, dk, dv, dlw, du.to(u.dtype)


wkv6_bwd.launches = 0
wkv6_bwd.kernel_launches = 0
