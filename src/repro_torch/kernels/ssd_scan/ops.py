"""Mamba2 SSD chunked scan: the wrapper of the Hopper kernel and its plain
version.

:func:`ssd_scan` takes the reference's layout (``repro/kernels/ssd_scan/
ops.py``): ``xh [B, S, H, P]``, ``dt [B, S, H]`` (softplus'ed), ``A [H]``
(negative decay rates), ``Bm`` and ``Cm [B, S, N]`` shared by the heads,
and returns ``y [B, S, H, P]`` in ``xh``'s dtype. On a CUDA tensor it
launches ``csrc/ssd_scan.cu`` (built on first use, see
:mod:`repro_torch.kernels.build`) or raises; there is no fallback. On a CPU
tensor, and only there, it computes :func:`ssd_scan_plain`.
``ssd_scan.launches`` counts the wrapper's calls that launched the kernel,
one per call; ``ssd_scan.kernel_launches`` counts the device launches,
three per call (chunk states, the pass across chunks, the outputs), which
share an f32 workspace of ``[B, H, ceil(S / chunk), P, N]`` states the
wrapper allocates on the caller's stream.

The scan starts from a zero state and returns none, as the TPU kernel
does; the model's decode step, which carries a state, uses its own
recurrence (``models/ssm.py::_ssd_chunked``). The kernel masks the ragged
last chunk itself, so unlike the reference wrapper this one pads nothing.

:func:`ssd_scan_bwd` is the VJP (dxh, ddt, dA, dBm, dCm), the same file's
second entry point, with :func:`ssd_scan_bwd_plain` beside it and the same
CPU/CUDA rule. It runs at its own chunk ``min(chunk, S, BWD_CHUNK)`` (the
scan's value does not depend on the chunking, only its rounding does), in
five launches through an f32 workspace (:func:`ssd_bwd_work`) the wrapper
allocates: each chunk's own state and state gradient, the pass across
chunks that turns them into the state entering each chunk, the reverse
pass that turns the gradients into the gradient of the state leaving
each chunk, the per-chunk gradients, and the fixed-order sums of dB, dC
and dA. ``ssd_scan_bwd.launches`` counts its calls on the card and
``kernel_launches`` its device launches, five a call. On a shape-only
tensor it records :func:`ssd_bwd_cost` under ``ssd_scan_bwd`` and
allocates the outputs and the workspace. Under grad on the card
:func:`ssd_scan` goes through :class:`SSDScanFn`: the forward on one
kernel, the backward on the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..plain_grad import needs_grad, plain_grads
from ..shape_only import record, shape_only
from ...spans import spanned

__all__ = ["ssd_scan", "ssd_scan_plain", "SSDScanFn", "ssd_ops",
           "ssd_cost", "ssd_scan_bwd", "ssd_scan_bwd_plain", "ssd_bwd_ops",
           "ssd_bwd_ops_split", "ssd_bwd_cost", "ssd_bwd_work"]

MAX_P = 64                 # what csrc/ssd_scan.cu is built for
MAX_N = 64
MAX_CHUNK = 128
KERNELS_PER_CALL = 3       # chunk states, state pass, outputs
BWD_CHUNK = 64             # the backward's largest chunk (its tiles)
BWD_GROUP = 8              # heads a per-chunk block of the backward takes
BWD_KERNELS_PER_CALL = 5   # chunk states and state gradients, pass,
                           # reverse pass, per-chunk gradients, sums
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # as csrc/ instantiates
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


def ssd_ops(B, S, H, P, N, chunk) -> int:
    """The SSD scan's operations: per chunk of n rows, per b, the lower
    triangle's C.B products (n(n+1)/2 x N multiply-adds: B and C are
    shared by the heads, so C.B is needed once for all of them), and per
    (b, h) its weights (an exponential and two products each), its weighted
    sum of x (x P), the incoming-state term and the state update (n x P x N
    multiply-adds each): two operations a multiply-add, one an exponential
    or a product."""
    ops = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri = n * (n + 1) // 2
        ops += B * 2 * tri * N \
            + B * H * (2 * tri * P + 3 * tri + 2 * 2 * n * P * N)
    return ops


def ssd_cost(B, S, H, P, N, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): x, dt, B, C read once and y written once."""
    return (ssd_ops(B, S, H, P, N, chunk),
            (2 * B * S * H * P + B * S * H + 2 * B * S * N) * itemsize)


def ssd_bwd_ops_split(B, S, H, P, N, chunk) -> tuple[int, int]:
    """The SSD scan's VJP's operations at the backward's chunk
    ``min(chunk, S, BWD_CHUNK)``, as (products, the rest). Products: per
    chunk of n rows, per b, C.B^T and the head-summed dCB's two products
    into dB and dC (3 x n(n+1)/2 x N multiply-adds); per (b, h) dy.x^T and
    W^T dy (2 x n(n+1)/2 x P) and five n x P x N products (the recomputed
    state, its gradient, g_c B, g_c^T x, dy h_c). The rest: per (b, h) the
    pair terms (8 a pair: the exponential, W, dWE, Q, dCB and two sums) and
    the two carries (2 x P x N). Two operations a multiply-add. Both are
    the function's float32 operations; the kernel runs each product as
    three TF32 tensor-core products (3xTF32), the rest on the f32 units."""
    c = max(1, min(chunk, S, BWD_CHUNK))
    products = rest = 0
    for t0 in range(0, S, c):
        n = min(c, S - t0)
        tri = n * (n + 1) // 2
        products += B * 2 * 3 * tri * N + B * H * (
            2 * 2 * tri * P + 2 * 5 * n * P * N)
        rest += B * H * (8 * tri + 2 * 2 * P * N)
    return products, rest


def ssd_bwd_ops(B, S, H, P, N, chunk) -> int:
    """All of :func:`ssd_bwd_ops_split`'s operations."""
    return sum(ssd_bwd_ops_split(B, S, H, P, N, chunk))


def ssd_bwd_cost(B, S, H, P, N, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): x, dt, B, C and dy read once, dx, ddt, dB and
    dC written once."""
    return (ssd_bwd_ops(B, S, H, P, N, chunk),
            (3 * B * S * H * P + 2 * B * S * H + 4 * B * S * N) * itemsize)


def ssd_bwd_work(B, S, H, P, N, chunk) -> int:
    """Floats of the backward's workspace (``ssd_scan_bwd_launch``): dA's
    f64 partials [B, nc, H], the states entering each chunk and their
    decays, the state gradients [B, H, nc, P, N], dB's and dC's partials
    [groups, B, S, N]; each of the first regions rounded up to 16 bytes."""
    c = max(1, min(chunk, S, BWD_CHUNK))
    nc = -(-S // c)
    bhc = B * H * nc
    groups = -(-H // BWD_GROUP)

    def r4(f):
        return -(-f // 4) * 4
    return r4(2 * bhc) + 2 * bhc * P * N + r4(bhc) + 2 * groups * B * S * N


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = 128) -> torch.Tensor:
    """The Pallas body (``_ssd_kernel``) chunk by chunk in plain torch, all
    (batch, head) pairs at once: f32 throughout, S zero-padded to a
    multiple of ``c = min(chunk, S)``, y rounded to ``xh.dtype``."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S == 0:
        return torch.empty_like(xh)
    c = min(chunk, S)
    pad = (-S) % c

    def padded(t):                          # zeros past S, in f32
        return torch.nn.functional.pad(t.float(),
                                       (0, 0) * (t.dim() - 2) + (0, pad))

    x, d, Bf, Cf = padded(xh), padded(dt), padded(Bm), padded(Cm)
    a = A.float()
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=xh.device)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=xh.device))
    ys = []
    for i0 in range(0, S + pad, c):
        xj, dtj = x[:, i0:i0 + c], d[:, i0:i0 + c]          # [B,c,H,P], [B,c,H]
        Bj, Cj = Bf[:, i0:i0 + c], Cf[:, i0:i0 + c]         # [B,c,N]
        seg = torch.cumsum(dtj * a, dim=1)                   # [B,c,H]
        diff = seg[:, :, None] - seg[:, None, :]             # [B,t,s,H]
        # mask the exponent's input: s > t differences are positive
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None], -1e30))
        cb = torch.einsum("btn,bsn->bts", Cj, Bj)
        w = cb[..., None] * decay * dtj[:, None]             # [B,t,s,H]
        y = torch.einsum("btsh,bshp->bthp", w, xj)
        y = y + torch.einsum("btn,bhpn->bthp", Cj,
                             h) * torch.exp(seg)[..., None]
        ys.append(y)
        tail = torch.exp(seg[:, -1:] - seg) * dtj            # [B,c,H]
        upd = torch.einsum("bshp,bsn->bhpn", xj * tail[..., None], Bj)
        h = torch.exp(seg[:, -1])[..., None, None] * h + upd
    return torch.cat(ys, dim=1)[:, :S].to(xh.dtype)


def ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, dy, *, chunk: int = 128):
    """The backward kernel's function in plain torch: autograd through
    :func:`ssd_scan_plain` at dy. Returns ``(dxh, ddt, dA, dBm, dCm)``."""
    return tuple(plain_grads(ssd_scan_plain, (xh, dt, A, Bm, Cm),
                             (True,) * 5, dy, chunk=chunk))


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(xh, dt, A, Bm, Cm, chunk) -> None:
    if xh.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_scan: unsupported dtype {xh.dtype}")
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan: xh must be [B, S, H, P], got "
                         f"{tuple(xh.shape)}")
    B, S, H, P = xh.shape
    if Bm.dim() != 3:
        raise ValueError(f"ssd_scan: Bm must be [B, S, N], got "
                         f"{tuple(Bm.shape)}")
    want = {"dt": (dt, (B, S, H)), "A": (A, (H,)),
            "Bm": (Bm, (B, S, Bm.shape[-1])), "Cm": (Cm, tuple(Bm.shape))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xh on "
                             f"{xh.device}")
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be an int >= 1, got {chunk!r}")


class SSDScanFn(torch.autograd.Function):
    """:func:`ssd_scan` under grad. ``kernel(xh, dt, A, Bm, Cm, chunk)``
    computes the forward and ``backward(xh, dt, A, Bm, Cm, dy, chunk)`` all
    five gradients (on the card the two kernels' launches; a test may pass
    stand-ins); only the inputs are saved, and an input that needs no
    gradient gets None."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk, kernel, backward):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.bwd = backward
        return kernel(xh, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ctx.bwd(*ctx.saved_tensors, dy.contiguous(), ctx.chunk)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad[:5])), None, None, None)


@spanned("turnip.kernel.ssd_scan")
def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) dt_s e^{seg_t - seg_s} x_s per head, from a
    zero state, in chunks of ``min(chunk, S)``; ``seg`` is the cumulative
    sum of ``dt * A`` within a chunk. Returns ``[B, S, H, P]`` in
    ``xh.dtype``."""
    _check(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type == "cpu" and not shape_only(xh):
        return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk=chunk)
    if xh.device.type != "cuda" and not shape_only(xh):
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    if needs_grad(xh, dt, A, Bm, Cm):
        return SSDScanFn.apply(xh, dt, A, Bm, Cm, chunk, _launch,
                               _launch_bwd)
    return _launch(xh, dt, A, Bm, Cm, chunk)


def _launch(xh, dt, A, Bm, Cm, chunk) -> torch.Tensor:
    """The kernel's three launches on checked CUDA tensors."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if shape_only(xh):
        record("ssd_scan", *ssd_cost(B, S, H, P, N, min(int(chunk), S),
                                     xh.element_size()))
        return torch.empty_like(xh)
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != xh.dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}, xh {xh.dtype}")
    for name, t in (("xh", xh), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous (strides "
                             f"{tuple(t.stride())})")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_scan: the kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P {P}, N {N}")
    c = min(int(chunk), S)
    if c > MAX_CHUNK:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"got {c}")
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y
    a = A.to(torch.float32).contiguous()
    nc = -(-S // c)
    work = torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                       device=xh.device)
    err = _launcher()(xh.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                      work.data_ptr(), B, S, H, P, N, c,
                      _DTYPE_CODE[xh.dtype],
                      torch.cuda.current_stream(xh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    with _count_lock:
        ssd_scan.launches += 1
        ssd_scan.kernel_launches += KERNELS_PER_CALL
    return y


ssd_scan.launches = 0
ssd_scan.kernel_launches = 0


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        from ..build import library
        fn = library("ssd_scan").ssd_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128):
    """The VJP of :func:`ssd_scan` at ``dy`` (``xh``'s shape and dtype):
    ``(dxh, ddt, dA, dBm, dCm)``, each in its input's dtype."""
    _check(xh, dt, A, Bm, Cm, chunk)
    if tuple(dy.shape) != tuple(xh.shape) or dy.device != xh.device:
        raise ValueError(f"ssd_scan_bwd: dy must be {tuple(xh.shape)} on "
                         f"{xh.device}, got {tuple(dy.shape)} on "
                         f"{dy.device}")
    if xh.device.type == "cpu" and not shape_only(xh):
        return ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, dy, chunk=chunk)
    if xh.device.type != "cuda" and not shape_only(xh):
        raise ValueError(f"ssd_scan_bwd: no kernel for device {xh.device}")
    return _launch_bwd(xh, dt, A, Bm, Cm, dy, chunk)


@spanned("turnip.kernel.ssd_scan_bwd")
def _launch_bwd(xh, dt, A, Bm, Cm, dy, chunk):
    """The backward's five launches on checked CUDA tensors."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    c = max(1, min(int(chunk), S, BWD_CHUNK))
    grads = (torch.empty_like(xh), torch.empty_like(dt),
             torch.empty(H, dtype=torch.float32, device=xh.device),
             torch.empty_like(Bm), torch.empty_like(Cm))
    work = torch.empty(ssd_bwd_work(B, S, H, P, N, c), dtype=torch.float32,
                       device=xh.device)
    if shape_only(xh):
        record("ssd_scan_bwd", *ssd_bwd_cost(B, S, H, P, N, c,
                                             xh.element_size()))
        return (*grads[:2], grads[2].to(A.dtype), *grads[3:])
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("dy", dy)):
        if t.dtype != xh.dtype:
            raise ValueError(f"ssd_scan_bwd: {name} is {t.dtype}, xh "
                             f"{xh.dtype}")
    for name, t in (("xh", xh), ("dt", dt), ("Bm", Bm), ("Cm", Cm),
                    ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {name} must be contiguous "
                             f"(strides {tuple(t.stride())})")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_scan_bwd: the kernel takes P <= {MAX_P} and "
                         f"N <= {MAX_N}, got P {P}, N {N}")
    dx, ddt, dA, dB, dC = grads
    if dx.numel() == 0:
        return dx, ddt, dA.zero_().to(A.dtype), dB, dC
    a = A.to(torch.float32).contiguous()
    err = _bwd_launcher()(xh.data_ptr(), dt.data_ptr(), a.data_ptr(),
                          Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                          dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                          dB.data_ptr(), dC.data_ptr(), work.data_ptr(),
                          B, S, H, P, N, c, _DTYPE_CODE[xh.dtype],
                          torch.cuda.current_stream(xh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError "
                           f"{err}")
    with _count_lock:
        ssd_scan_bwd.launches += 1
        ssd_scan_bwd.kernel_launches += BWD_KERNELS_PER_CALL
    return dx, ddt, dA.to(A.dtype), dB, dC


ssd_scan_bwd.launches = 0
ssd_scan_bwd.kernel_launches = 0
