"""Flash attention: the wrapper of the Hopper kernel and its plain version.

:func:`flash_attention` takes the model layout: q ``[B, Sq, Hq, Dh]``, k and
v ``[B, Skv, Hkv, Dh]`` with ``Hq % Hkv == 0``, and returns
``[B, Sq, Hq, Dh]``. On a CUDA tensor it launches
``csrc/flash_attention.cu`` (built on first use, see
:mod:`repro_torch.kernels.build`) or raises; there is no fallback. On a CPU
tensor, and only there, it computes :func:`flash_attention_plain`.
``flash_attention.launches`` counts the kernel's launches, and by instance
``launches_tc`` (16-bit: the wgmma kernel) and ``launches_scalar``
(float32: scalar FMAs). :func:`attention_limit` is the rule a 16-bit kernel
output is held to against the plain version.

The kernel reads through the tensors' strides and masks the ragged edges
itself, so unlike the reference wrapper (``repro/kernels/flash_attention/
ops.py``) this one neither transposes nor pads. It also exposes
``q_offset``, the absolute position of ``q[:, 0]`` for a chunk of queries
against a longer KV.

:func:`flash_attention_bwd` is the VJP (dQ, dK, dV) from the forward's
per-row log-sum-exp (``lse=``, an optional output of the forward launch),
``csrc/flash_attention_bwd.cu``: two device launches a call (Di and dQ,
then dK and dV), neither of which materialises the scores.
:func:`flash_attention_bwd_plain` is its plain version (it does
materialise them, one KV head at a time), and :class:`FlashAttentionFn`
the ``torch.autograd.Function`` of the pair, with the same CPU/CUDA rule.
``flash_attention_bwd.launches`` counts calls on the card, by instance
``launches_tc`` (16-bit: the wgmma kernels) and ``launches_scalar``
(float32), and ``kernel_launches`` the device launches.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

__all__ = ["flash_attention", "flash_attention_plain", "attention_limit",
           "gradient_limit", "lse_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttentionFn", "NEG_INF"]

NEG_INF = -1e30                  # the TPU kernel's masked score (not -inf)
HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# float32 kernel vs plain: |k - p| <= atol + rtol * |p|, about one unit in
# the last place (the two differ in the f32 summation order)
F32_TOL = (2e-5, 2e-4)
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: float32, or float64 for float64 inputs (the
    autograd checks run in float64)."""
    return torch.promote_types(dtype, torch.float32)


def _visible(Sq: int, Skv: int, causal: bool, q_offset: int, device,
             true_skv: int | None = None) -> torch.Tensor:
    """[Sq, Skv] bool: the (query, key) pairs the kernel does not mask."""
    kv_pos = torch.arange(Skv, device=device)
    mask = (kv_pos < (Skv if true_skv is None else true_skv)).expand(Sq, Skv)
    if causal:
        q_pos = torch.arange(Sq, device=device) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    return mask


def attention_limit(want, name: str):
    """Elementwise limit on |kernel - plain| for an attention output
    [..., Dh]. float32: F32_TOL. 16-bit: two units in the last place of
    |plain| (2^-6 relative in bfloat16, 2^-9 in float16: the two differ
    in the f32 summation order, then each rounds once), plus 2^-8 of the
    row's rms for outputs near zero. A row's outputs shrink as it sees more
    keys (~sqrt(e / keys) for unit inputs at these head sizes: 0.018 at key
    8192), so a limit fixed in absolute terms would pass a wrong late row;
    this one scales with each row."""
    want = want.float()
    if name == "float32":
        atol, rtol = F32_TOL
        return atol + rtol * want.abs()
    ulp = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[name]
    rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    return 2 * ulp * want.abs() + 2.0 ** -8 * rms


def gradient_limit(want, name: str):
    """Elementwise limit on |kernel - plain| for a gradient dQ, dK or dV
    [..., Dh]: :func:`attention_limit`, plus 2^-12 of the whole tensor's
    rms. The floor is for rows whose exact gradient vanishes: a causal row
    that sees one key has dS = P∘(dP − Di) = 0, and both versions hold only
    the f32 rounding of dP − Di there (~1e-7 of the terms), which the
    row's own rms cannot scale."""
    want = want.float()
    return attention_limit(want, name) + 2.0 ** -12 * want.square().mean().sqrt()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          true_skv: int | None = None) -> torch.Tensor:
    """The kernel's function in plain torch, materialising the f32 scores
    as ``repro/kernels/flash_attention/ref.py`` does: KV positions at or
    past ``true_skv`` (default: all of k) and, when causal, past
    ``q + q_offset`` score −1e30; the softmax sum is clamped at 1e-30 as
    the TPU kernel clamps it."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    acc = _acc(q.dtype)
    qf = q.to(acc).reshape(B, Sq, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(acc)) * (1.0 / math.sqrt(Dh))
    mask = _visible(Sq, Skv, causal, q_offset, q.device, true_skv)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(acc)) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor | None = None,
                              *, causal: bool = True, q_offset: int = 0):
    """The backward kernel's formulas in plain torch, materialising the
    scores one KV head (its G query heads) at a time: P = exp(S·scale −
    lse) over the forward's masking (lse, f32 [B, Hq, Sq], computed here
    when not given), Di = rowsum(dO∘O), dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P∘(dP − Di), dQ = dS K·scale, dK = dSᵀ Q·scale; f32 (f64 for f64
    inputs), each gradient rounded once to its input's type. Returns
    ``(dq, dk, dv)``."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    acc = _acc(q.dtype)
    scale = 1.0 / math.sqrt(Dh)
    mask = _visible(Sq, Skv, causal, q_offset, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for hk in range(Hkv):
        hs = slice(hk * G, (hk + 1) * G)
        qh, oh, doh = (t[:, :, hs].to(acc) for t in (q, o, do))   # [B,Sq,G,D]
        kh, vh = k[:, :, hk].to(acc), v[:, :, hk].to(acc)          # [B,Skv,D]
        s = torch.einsum("bqgd,bkd->bgqk", qh, kh) * scale
        s = s.masked_fill(~mask, NEG_INF)
        if lse is None:
            lh = torch.logsumexp(s, dim=-1, keepdim=True)
        else:
            lh = lse[:, hs, :, None].to(acc)
        p = torch.exp(s - lh)
        del s
        di = (doh * oh).sum(dim=-1).permute(0, 2, 1)[..., None]   # [B,G,Sq,1]
        dv[:, :, hk] = torch.einsum("bgqk,bqgd->bkd", p, doh).to(v.dtype)
        ds = p.mul_(torch.einsum("bqgd,bkd->bgqk", doh, vh).sub_(di))
        dq[:, :, hs] = (torch.einsum("bgqk,bkd->bqgd", ds, kh)
                        * scale).to(q.dtype)
        dk[:, :, hk] = (torch.einsum("bgqk,bqgd->bkd", ds, qh)
                        * scale).to(k.dtype)
        del p, ds
    return dq, dk, dv


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        from ..build import library
        fn = library("flash_attention_bwd").flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _check(q, k, v, q_offset, out) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, H, Dh], "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have a contiguous "
                             f"last dimension (strides {tuple(t.stride())})")
    B, Sq, Hq, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {Dh} not in {HEAD_DIMS}")
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be an int >= 0, "
                         f"got {q_offset!r}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device or out.stride(-1) != 1):
        raise ValueError(f"flash_attention: out must be {tuple(q.shape)} "
                         f"{q.dtype} on {q.device} with a contiguous last "
                         f"dimension")


def _check_lse(lse, q) -> None:
    B, Sq, Hq, _ = q.shape
    if lse is not None and (lse.shape != (B, Hq, Sq) or lse.dtype !=
                            torch.float32 or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous float32 "
                         f"[{B}, {Hq}, {Sq}] on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    out: torch.Tensor | None = None,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of q ``[B, Sq, Hq, Dh]`` over k/v ``[B, Skv, Hkv, Dh]``,
    query head h reading KV head ``h // (Hq // Hkv)``; causal masking puts
    ``q[:, i]`` at absolute position ``i + q_offset``. Written into ``out``
    when given; each row's log-sum-exp of its scaled scores written into
    ``lse`` (float32 ``[B, Hq, Sq]``) when given."""
    _check(q, k, v, q_offset, out)
    _check_lse(lse, q)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
        if lse is not None:
            lse.copy_(lse_plain(q, k, causal, q_offset))
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: empty KV")
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, Sq, Skv, Hq, Hkv, Dh, int(q_offset), int(bool(causal)),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    with _count_lock:
        flash_attention.launches += 1
        if q.dtype == torch.float32:
            flash_attention.launches_scalar += 1
        else:
            flash_attention.launches_tc += 1
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_scalar = 0


def lse_plain(q, k, causal: bool, q_offset: int) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores, f32 [B, Hq, Sq]
    (the forward kernel's ``lse``)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qf = q.to(_acc(q.dtype)).reshape(B, Sq, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(qf.dtype)) / math.sqrt(Dh)
    s = s.masked_fill(~_visible(Sq, Skv, causal, q_offset, q.device), NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq).float()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0):
    """dQ, dK, dV of :func:`flash_attention` at ``(q, k, v)`` with output
    ``o``, its gradient ``do`` (both ``[B, Sq, Hq, Dh]``) and the forward's
    ``lse``. Returns fresh contiguous ``(dq, dk, dv)``."""
    _check(q, k, v, q_offset, None)
    _check_lse(lse, q)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)} {q.dtype} on {q.device} with "
                             f"a contiguous last dimension")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if Skv == 0:
        raise ValueError("flash_attention_bwd: empty KV")
    di = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, o, do, dq, dk, dv)
                                      for st in t.stride()[:3]))
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ctypes.addressof(strides), B, Sq, Skv, Hq, Hkv, Dh,
        int(q_offset), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    with _count_lock:
        flash_attention_bwd.launches += 1
        flash_attention_bwd.kernel_launches += 2
        if q.dtype == torch.float32:
            flash_attention_bwd.launches_scalar += 1
        else:
            flash_attention_bwd.launches_tc += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
flash_attention_bwd.launches_scalar = 0
flash_attention_bwd.kernel_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) with its VJP: the forward kernel (writing
    each row's log-sum-exp) and the backward kernels on CUDA, the plain
    versions on the CPU. Saves q, k, v, o and, on CUDA, the f32 lse
    (4 bytes a query row and head); nothing of size Sq x Skv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        lse = None
        if q.device.type == "cpu":
            o = flash_attention_plain(q, k, v, causal=causal,
                                      q_offset=q_offset)
        else:
            B, Sq, Hq, _ = q.shape
            lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                              device=q.device)
            o = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, do, causal=ctx.causal, q_offset=ctx.q_offset)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                             causal=ctx.causal,
                                             q_offset=ctx.q_offset)
        return dq, dk, dv, None, None
