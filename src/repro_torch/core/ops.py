"""Numeric op registry for MEMGRAPH execution, in PyTorch.

The TURNIP runtime is kernel-agnostic: a TASKGRAPH vertex names an op in
this registry. The names and parameters are the reference registry's
(``repro/core/ops.py``); each op here is a torch function of the same
meaning. ``rmsnorm`` goes to the hand-written Hopper kernel
(:mod:`repro_torch.kernels.rmsnorm.ops`), the port of the Pallas kernel
the reference registers under that name for TPU targets; the rest are
plain torch (cuBLAS for the products).

Every op is ``f(*operand_values, out=None, **params) -> torch.Tensor``.
With ``out`` (a typed view of the vertex's planned arena extent), the op
writes its result there and returns ``out``; without, it returns a fresh
contiguous tensor holding the same bytes. Operands are never written.

**Static placement (ROADMAP C2).** With ``out``, an op allocates no
full-size temporary: the planner's HBM budget is the arena, and anything
an op allocates beside it is HBM the plan did not account for. Ops write
through ``out=`` kernels, use ``out`` itself as scratch, or keep their
scratch row-sized (a reduction's ``[..., 1]``, LoRA's ``[T, rank]``, a
causal mask's :data:`MASK_BLOCK`-square tile, ``rmsnorm_bwd``'s float64
row chunks of at most :data:`ROW_SCRATCH_BYTES`).
Ops are deterministic given their operands, so any dependency-respecting
execution order yields identical results (floating-point commutativity of
the streaming ``add_into`` accumulation is the one paper-sanctioned
exception, §8 "asynchronous partial summations").

:data:`PLAIN` holds the plain-torch version of every op that has a
kernel; :func:`get_op` with ``plain=True`` returns it, which is how the
port's reference evaluation runs without the kernels.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel
from ..kernels.rmsnorm.ops import rmsnorm_plain
from .taskgraph import TensorSpec

__all__ = ["OPS", "PLAIN", "register", "get_op"]

OPS: dict[str, Callable] = {}
PLAIN: dict[str, Callable] = {}


def register(name: str) -> Callable[[Callable], Callable]:
    def deco(fn: Callable) -> Callable:
        if name in OPS:
            raise ValueError(f"op {name!r} already registered")
        OPS[name] = fn
        return fn
    return deco


def get_op(name: str, *, plain: bool = False) -> Callable:
    if plain and name in PLAIN:
        return PLAIN[name]
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"unknown op {name!r}; registered: {sorted(OPS)}") from None


def _into(out: torch.Tensor | None, value: torch.Tensor) -> torch.Tensor:
    """Place a computed value: copied into ``out`` when given, else
    returned as a contiguous tensor of its own."""
    if out is None:
        return value.contiguous()
    return out.copy_(value)


# ---------------------------------------------------------------- basics
@register("copy")
def _copy(x, *, out=None, **_):
    if out is None:
        return x.clone(memory_format=torch.contiguous_format)
    return out.copy_(x)


@register("zeros")
def _zeros(*_, shape=(1,), dtype="float32", out=None, device=None, **__):
    if out is not None:
        return out.zero_()
    return torch.zeros(tuple(shape), dtype=TensorSpec((), dtype).torch_dtype,
                       device=device)


@register("add")
def _add(x, y, *, out=None, **_):
    return torch.add(x, y, out=out)


@register("sum")
def _sum(*xs, out=None, **_):
    acc = torch.add(xs[0], xs[1], out=out) if len(xs) > 1 else _copy(xs[0], out=out)
    for x in xs[2:]:
        acc = acc.add_(x) if out is not None else acc + x
    return acc


@register("mul")
def _mul(x, y, *, out=None, **_):
    return torch.mul(x, y, out=out)


@register("scale")
def _scale(x, *, alpha=1.0, out=None, **_):
    return torch.mul(x, alpha, out=out)


@register("matmul")
def _matmul(x, y, *, out=None, **_):
    return torch.matmul(x, y, out=out)


@register("matmul_t")
def _matmul_t(x, y, *, out=None, **_):
    return torch.matmul(x, y.transpose(-1, -2), out=out)


@register("relu")
def _relu(x, *, out=None, **_):
    return torch.clamp(x, min=0, out=out)


def _fresh(out: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """``out``, or a fresh contiguous tensor shaped like ``like``: an op
    computes into either the same way, so both give the same bytes."""
    return torch.empty_like(like, memory_format=torch.contiguous_format) \
        if out is None else out


@register("gelu")
def _gelu(x, *, out=None, **_):
    return torch.ops.aten.gelu.out(x, approximate="tanh", out=_fresh(out, x))


@register("silu")
def _silu(x, *, out=None, **_):
    return torch.sigmoid(x, out=out).mul_(x)


@register("tanh")
def _tanh(x, *, out=None, **_):
    return torch.tanh(x, out=out)


@register("transpose")
def _transpose(x, *, out=None, **_):
    return _into(out, x.transpose(-1, -2))


@register("slice_rows")
def _slice_rows(x, *, start=0, stop=None, out=None, **_):
    return _into(out, x[start:stop])


@register("concat")
def _concat(*xs, axis=0, out=None, **_):
    return torch.cat(xs, dim=axis, out=out)


# ---------------------------------------------------------- attention bits
@register("rmsnorm")
def _rmsnorm(x, g, *, eps=1e-6, out=None, **_):
    # The Hopper kernel: f32 accumulation as the Pallas kernel does (the
    # reference's numpy op accumulates in float64; ROADMAP C6).
    return _rmsnorm_kernel(x, g, eps=eps, out=out)


def _rmsnorm_plain(x, g, *, eps=1e-6, out=None, **_):
    return _into(out, rmsnorm_plain(x, g, eps=eps))


PLAIN["rmsnorm"] = _rmsnorm_plain


@register("softmax")
def _softmax(x, *, out=None, **_):
    # torch.softmax's own kernel, writing into out
    return torch.ops.aten._softmax.out(x, -1, False, out=_fresh(out, x))


def _mask_fill(dtype: torch.dtype) -> float:
    # the reference's -1e30, rounded to ``dtype`` as numpy rounds it:
    # -inf in float16 (no causal row is fully masked, so softmax stays finite)
    return float(torch.tensor(-1e30, dtype=torch.float64).to(dtype))


# the causal mask is applied a row block at a time: the block's columns
# past its last row's horizon are filled outright (a view, no mask), and
# the band in between takes one MASK_BLOCK-square triangle, cached per
# device — the only scratch ``scores`` allocates
MASK_BLOCK = 128
_TRI: dict[torch.device, torch.Tensor] = {}
_TRI_LOCK = threading.Lock()


def _upper_tri(device: torch.device) -> torch.Tensor:
    """[b, b] bool, True where column >= row.

    The tile is shared by every stream of the device, so it is published
    only once its fill has finished: on CUDA the building stream is
    synchronised before the tile enters :data:`_TRI`. Otherwise a vertex
    on another stream could read it before the fill had run."""
    tri = _TRI.get(device)
    if tri is not None:
        return tri
    with _TRI_LOCK:
        tri = _TRI.get(device)
        if tri is None:
            b = MASK_BLOCK
            tri = torch.ones(b, b, dtype=torch.bool, device=device).triu_()
            if tri.is_cuda:
                torch.cuda.current_stream(tri.device).synchronize()
            _TRI[device] = tri
    return tri


def _causal_fill_(s: torch.Tensor, q_offset: int) -> None:
    """Fill s[..., i, j] for j > i + q_offset with the mask constant, in
    place. For rows [r0, r1) the columns from r1 + q_offset on are masked
    in every row; columns [r0 + q_offset + 1, r1 + q_offset) form a band
    whose row i, local column c is masked iff c >= i - r0: the upper
    triangle (with diagonal) of a square, the same for every block."""
    n, m = s.shape[-2], s.shape[-1]
    fill = _mask_fill(s.dtype)
    tri = _upper_tri(s.device)
    for r0 in range(0, n, MASK_BLOCK):
        r1 = min(n, r0 + MASK_BLOCK)
        full = max(0, r1 + q_offset)
        if full < m:
            s[..., r0:r1, full:].fill_(fill)
        band0 = r0 + q_offset + 1              # band column c = 0 here
        c0, c1 = max(0, band0), min(m, full)
        if c0 < c1:
            s[..., r0:r1, c0:c1].masked_fill_(
                tri[:r1 - r0, c0 - band0:c1 - band0], fill)


@register("scores")
def _scores(q, k, *, scale=1.0, causal=False, q_offset=0, out=None, **_):
    """q: [..., Sq, Dh] block at absolute offset q_offset; k: [..., Skv, Dh]."""
    s = torch.matmul(q, k.transpose(-1, -2), out=out).mul_(scale)
    if causal:
        _causal_fill_(s, q_offset)
    return s


@register("attn_out")
def _attn_out(p, v, *, out=None, **_):
    return torch.matmul(p, v, out=out)


@register("lora_delta")
def _lora_delta(x, a, b, *, alpha=16.0, rank=16, out=None, **_):
    # x @ A^T @ B^T * (alpha/rank) — LoRA adapter path (paper §8 training)
    t = torch.matmul(x, a.transpose(-1, -2))
    return torch.matmul(t, b.transpose(-1, -2), out=out).mul_(alpha / rank)


# ------------------------------------------------- exact backward fragments
@register("matmul_tn")
def _matmul_tn(x, y, *, out=None, **_):
    """x^T @ y — the dW fragment."""
    return torch.matmul(x.transpose(-1, -2), y, out=out)


@register("softmax_bwd")
def _softmax_bwd(p, dp, *, out=None, **_):
    """VJP of softmax: p ⊙ (dp − Σ(dp⊙p)); dp⊙p is formed in ``out``."""
    out = torch.mul(dp, p, out=_fresh(out, dp))
    s = out.sum(dim=-1, keepdim=True)
    return torch.sub(dp, s, out=out).mul_(p)


@register("gelu_bwd")
def _gelu_bwd(x, dy, *, out=None, **_):
    """dy ⊙ gelu'(x), tanh form: torch's own backward kernel, writing into
    out (the reference's formula, evaluated in float32 for 16-bit x)."""
    return torch.ops.aten.gelu_backward.grad_input(
        dy, x, approximate="tanh", grad_input=_fresh(out, x))


# rmsnorm_bwd's float64 scratch: rows are taken in chunks of at most this
# many bytes of one float64 [rows, D] temporary
ROW_SCRATCH_BYTES = 1 << 20


@register("rmsnorm_bwd")
def _rmsnorm_bwd(x, g, dy, *, eps=1e-6, out=None, **_):
    """Exact VJP of rmsnorm wrt x (gamma frozen in LoRA training); float64
    arithmetic, as the reference op, a chunk of rows at a time."""
    out = _fresh(out, x)
    D = x.shape[-1]
    xs, dys, outs = x.reshape(-1, D), dy.reshape(-1, D), out.view(-1, D)
    gf = g.double()
    step = max(1, ROW_SCRATCH_BYTES // (8 * D))
    for a in range(0, xs.shape[0], step):
        xf = xs[a:a + step].double()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
        dyg = dys[a:a + step].double().mul_(gf)
        s = (dyg * xf).sum(dim=-1, keepdim=True)
        dx = dyg.mul_(r).sub_(xf.mul_(r ** 3 / D).mul_(s))
        outs[a:a + step].copy_(dx)
    return out


@register("split_heads")
def _split_heads(x, *, n_heads=1, out=None, **_):
    """[T, H*dh] → [H, T, dh] (batched per-head attention math)."""
    T, W = x.shape
    return _into(out, x.reshape(T, n_heads, W // n_heads).transpose(0, 1))


@register("merge_heads")
def _merge_heads(x, *, out=None, **_):
    """[H, T, dh] → [T, H*dh]."""
    H, T, dh = x.shape
    if out is None:
        return x.transpose(0, 1).reshape(T, H * dh)
    out.view(T, H, dh).copy_(x.transpose(0, 1))
    return out


@register("slice_rows_3d")
def _slice_rows_3d(x, *, start=0, stop=None, out=None, **_):
    """Slice axis 1 of [H, T, dh]."""
    return _into(out, x[:, start:stop])
