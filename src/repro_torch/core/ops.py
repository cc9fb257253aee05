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
writes its result there wherever torch allows it, and returns ``out``;
without, it returns a fresh contiguous tensor. Operands are never written.
Ops are deterministic given their operands, so any dependency-respecting
execution order yields identical results (floating-point commutativity of
the streaming ``add_into`` accumulation is the one paper-sanctioned
exception, §8 "asynchronous partial summations").

:data:`PLAIN` holds the plain-torch version of every op that has a
kernel; :func:`get_op` with ``plain=True`` returns it, which is how the
port's reference evaluation runs without the kernels.
"""
from __future__ import annotations

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


@register("gelu")
def _gelu(x, *, out=None, **_):
    return _into(out, F.gelu(x, approximate="tanh"))


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
    return _into(out, torch.softmax(x, dim=-1))


def _mask_fill(dtype: torch.dtype) -> float:
    # the reference's -1e30, rounded to ``dtype`` as numpy rounds it:
    # -inf in float16 (no causal row is fully masked, so softmax stays finite)
    return float(torch.tensor(-1e30, dtype=torch.float64).to(dtype))


@register("scores")
def _scores(q, k, *, scale=1.0, causal=False, q_offset=0, out=None, **_):
    """q: [..., Sq, Dh] block at absolute offset q_offset; k: [..., Skv, Dh]."""
    s = torch.matmul(q, k.transpose(-1, -2), out=out).mul_(scale)
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        qpos = torch.arange(n, device=s.device) + q_offset
        masked = torch.arange(m, device=s.device)[None, :] > qpos[:, None]
        s.masked_fill_(masked, _mask_fill(s.dtype))
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
    """VJP of softmax: p ⊙ (dp − Σ(dp⊙p))."""
    s = (dp * p).sum(dim=-1, keepdim=True)
    return torch.sub(dp, s, out=out).mul_(p)


@register("gelu_bwd")
def _gelu_bwd(x, dy, *, out=None, **_):
    c = 0.7978845608028654
    t = torch.tanh(c * (x + 0.044715 * x ** 3))
    dg = 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t ** 2) * c * (1 + 3 * 0.044715 * x ** 2)
    return torch.mul(dy, dg, out=out)


@register("rmsnorm_bwd")
def _rmsnorm_bwd(x, g, dy, *, eps=1e-6, out=None, **_):
    """Exact VJP of rmsnorm wrt x (gamma frozen in LoRA training); float64
    arithmetic, as the reference op."""
    xf = x.double()
    D = xf.shape[-1]
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyg = dy.double() * g.double()
    dx = r * dyg - xf * (r ** 3 / D) * (dyg * xf).sum(dim=-1, keepdim=True)
    return _into(out, dx.to(x.dtype))


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
