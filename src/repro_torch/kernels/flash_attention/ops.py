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
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

__all__ = ["flash_attention", "flash_attention_plain", "attention_limit",
           "NEG_INF"]

NEG_INF = -1e30                  # the TPU kernel's masked score (not -inf)
HEAD_DIMS = (32, 64, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# float32 kernel vs plain: |k - p| <= atol + rtol * |p|, about one unit in
# the last place (the two differ in the f32 summation order)
F32_TOL = (2e-5, 2e-4)
_count_lock = threading.Lock()
_fn = None


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
    qf = q.float().reshape(B, Sq, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(Dh))
    kv_pos = torch.arange(Skv, device=q.device)
    mask = (kv_pos < (Skv if true_skv is None else true_skv)).expand(Sq, Skv)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def _launcher():
    global _fn
    if _fn is None:
        from ..build import library
        fn = library("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of q ``[B, Sq, Hq, Dh]`` over k/v ``[B, Skv, Hkv, Dh]``,
    query head h reading KV head ``h // (Hq // Hkv)``; causal masking puts
    ``q[:, i]`` at absolute position ``i + q_offset``. Written into ``out``
    when given."""
    _check(q, k, v, q_offset, out)
    if q.device.type == "cpu":
        o = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
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
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
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
