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
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["ssd_scan", "ssd_scan_plain"]

MAX_P = 64                 # what csrc/ssd_scan.cu is built for
MAX_N = 64
MAX_CHUNK = 128
KERNELS_PER_CALL = 3       # chunk states, state pass, outputs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # as csrc/ instantiates
_count_lock = threading.Lock()
_fn = None


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


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """y_t = sum_{s<=t} (C_t . B_s) dt_s e^{seg_t - seg_s} x_s per head, from a
    zero state, in chunks of ``min(chunk, S)``; ``seg`` is the cumulative
    sum of ``dt * A`` within a chunk. Returns ``[B, S, H, P]`` in
    ``xh.dtype``."""
    _check(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type == "cpu":
        return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk=chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
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
