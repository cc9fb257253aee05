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
"""
from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["wkv6", "wkv6_plain"]

MAX_P = 64                 # what csrc/wkv6.cu is built for
MAX_CHUNK = 64
GROUP = 16                 # chunks a workspace state covers
KERNELS_PER_CALL = 3       # group states, state pass, outputs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # as csrc/ instantiates
_count_lock = threading.Lock()
_fn = None


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


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         lw: torch.Tensor, u: torch.Tensor, *, chunk: int = 32
         ) -> torch.Tensor:
    """The WKV6 recurrence per head, from a zero state, in chunks of
    ``min(chunk, S)``: ``S_t = diag(e^{lw_t}) S_{t-1} + k_t^T v_t`` and
    ``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``. Returns ``[B, S, H, P]``
    in ``r.dtype``."""
    _check(r, k, v, lw, u, chunk)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    B, S, H, P = r.shape
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
