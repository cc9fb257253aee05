"""Transformer building blocks (plain functions on tensors).

The port of ``repro/models/layers.py``: same names, call signatures and the
``[B, S, H, Dh]`` attention layout. Three of them go to the port's Hopper
kernels on a CUDA tensor: :func:`rmsnorm` (``kernels/rmsnorm``),
:func:`blockwise_attention` (``kernels/flash_attention``) and the expert
products of :func:`moe_block` (``kernels/moe_gmm``); on a CPU tensor each
wrapper computes its kernel's plain version. Everything else is plain
torch, as the reference computes it outside any Pallas kernel.

Gradients: :func:`rmsnorm` and :func:`blockwise_attention` go through
``autograd.Function``s whose backward is a kernel too (``RMSNormFn``,
``FlashAttentionFn``). The grouped matmul, the SSD scan and WKV6 have no
backward kernel yet: under grad on CUDA their forward still runs the
kernel, and their gradient is their plain version's, recomputed
(``GroupedMatmulFn``, ``SSDScanFn``, ``WKV6Fn``; ROADMAP B5 replaces it).
On the CPU they stay plain torch and differentiable.

Parameters are dicts of tensors with the reference's keys. ``*_init``
functions draw with the reference's distributions and scales from an
explicit ``torch.Generator`` onto ``device`` (default CUDA); the bits differ
from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.flash_attention.ops import (FlashAttentionFn, NEG_INF,
                                           flash_attention)
from ..kernels.moe_gmm.ops import grouped_matmul
from ..kernels.plain_grad import needs_grad
from ..kernels.rmsnorm.ops import RMSNormFn, rmsnorm as _rmsnorm_kernel

__all__ = ["rmsnorm", "layernorm", "rope", "blockwise_attention",
           "decode_attention", "decode_attention_q8", "AttnParamsSpec",
           "attention_block", "swiglu_mlp", "gelu_mlp", "mlp_init", "moe_init",
           "moe_route", "moe_block", "randn"]


def randn(gen: torch.Generator, shape, dtype: torch.dtype, scale: float,
          device=None) -> torch.Tensor:
    """``normal(shape) * scale`` drawn from ``gen`` on ``device`` (default
    CUDA). The draw happens on the generator's device."""
    dev = resolve_device(device)
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return t.mul_(scale).to(dev)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * gamma, through the rmsnorm kernel (f32
    accumulation, one rounding to x.dtype) and its backward kernel
    (``RMSNormFn``). Without ``gamma`` it is plain torch."""
    if gamma is None:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps).to(x.dtype)
    if needs_grad(x, gamma):
        return RMSNormFn.apply(x, gamma, eps)
    return _rmsnorm_kernel(x, gamma, eps=eps)


def layernorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
              beta: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when gamma/beta are None (OLMo's non-parametric LN);
    plain torch, as no kernel computes it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].float() * freqs            # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0,
                        block_kv: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks: the flash-attention kernel,
    differentiable through its backward kernels (``FlashAttentionFn``).

    q: [B, Sq, Hq, Dh], k/v: [B, Skv, Hkv, Dh] with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0]. ``block_kv`` is the
    reference's XLA block size; the kernel keeps its own tiles, so it is
    accepted and not used."""
    del block_kv
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, int(q_offset))
    # no gradient: the forward alone, without the log-sum-exp
    return flash_attention(q, k, v, causal=causal, q_offset=int(q_offset))


def _mask_len(cache_len, Smax: int, device) -> torch.Tensor:
    """[B|1, Smax] bool: positions below each row's cache length."""
    lens = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    return torch.arange(Smax, device=device)[None, :] < lens


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """One-token attention against a [B, Smax, Hkv, Dh] cache."""
    B, Sq, Hq, Dh = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache) * scale
    mask = _mask_len(cache_len, Smax, q.device)
    s = s.float().masked_fill(~mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def decode_attention_q8(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, cache_len) -> torch.Tensor:
    """decode_attention over an int8 KV cache with per-(token, head) scales
    (KIVI-style, post-RoPE)."""
    B, Sq, Hq, Dh = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Hkv, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]     # [B,Hkv,1,1,S]
    mask = _mask_len(cache_len, Smax, q.device)
    s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bhgqk,bkhd->bhgqd", pv, v_cache.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnParamsSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False

    def init(self, gen: torch.Generator, dtype=torch.float32, *,
             leading: tuple[int, ...] = (), device=None) -> dict:
        """Projection weights, ``leading`` dims first (``(L,)`` stacks a
        model's layers)."""
        d, H, K, Dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        s = 1.0 / math.sqrt(d)
        p = {"wq": randn(gen, leading + (d, H * Dh), dtype, s, device),
             "wk": randn(gen, leading + (d, K * Dh), dtype, s, device),
             "wv": randn(gen, leading + (d, K * Dh), dtype, s, device),
             "wo": randn(gen, leading + (H * Dh, d), dtype, s, device)}
        if self.qkv_bias:
            dev = resolve_device(device)
            p["bq"] = torch.zeros(leading + (H * Dh,), dtype=dtype, device=dev)
            p["bk"] = torch.zeros(leading + (K * Dh,), dtype=dtype, device=dev)
            p["bv"] = torch.zeros(leading + (K * Dh,), dtype=dtype, device=dev)
        return p


def _proj(x: torch.Tensor, p: dict, w: str, b: str) -> torch.Tensor:
    y = x @ p[w]
    return y + p[b] if b in p else y


def attention_block(p: dict, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, d_head: int, positions: torch.Tensor,
                    causal: bool = True, rope_theta: float = 1e4,
                    kv: torch.Tensor | None = None,
                    block_kv: int = 1024) -> torch.Tensor:
    """Self- (or cross-, when ``kv`` given) attention with RoPE + GQA."""
    B, S, _ = x.shape
    src = x if kv is None else kv
    Skv = src.shape[1]
    q = _proj(x, p, "wq", "bq").reshape(B, S, n_heads, d_head)
    k = _proj(src, p, "wk", "bk").reshape(B, Skv, n_kv_heads, d_head)
    v = _proj(src, p, "wv", "bv").reshape(B, Skv, n_kv_heads, d_head)
    if kv is None and rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    o = blockwise_attention(q, k, v, causal=causal and kv is None,
                            block_kv=block_kv)
    return o.reshape(B, S, n_heads * d_head) @ p["wo"]


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(_proj(x, p, "wi", "bi"), approximate="tanh")
    return _proj(h, p, "wo", "bo")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32, bias: bool = False,
             *, leading: tuple[int, ...] = (), device=None) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    if kind == "swiglu":
        return {"wi_gate": randn(gen, leading + (d_model, d_ff), dtype, s_in,
                                 device),
                "wi_up": randn(gen, leading + (d_model, d_ff), dtype, s_in,
                               device),
                "wo": randn(gen, leading + (d_ff, d_model), dtype, s_out,
                            device)}
    p = {"wi": randn(gen, leading + (d_model, d_ff), dtype, s_in, device),
         "wo": randn(gen, leading + (d_ff, d_model), dtype, s_out, device)}
    if bias:
        dev = resolve_device(device)
        p["bi"] = torch.zeros(leading + (d_ff,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros(leading + (d_model,), dtype=dtype, device=dev)
    return p


# --------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-bounded or dropless)
# --------------------------------------------------------------------------
def moe_init(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, dtype=torch.float32, *,
             leading: tuple[int, ...] = (), device=None) -> dict:
    """The router in f32 whatever ``dtype``, as the reference draws it; the
    expert leaves drawn directly in ``dtype`` (never through an f32
    temporary of their size)."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_expert)
    return {
        "router": randn(gen, leading + (d_model, n_experts), torch.float32,
                        s_in, device),
        "wi_gate": randn(gen, leading + (n_experts, d_model, d_expert), dtype,
                         s_in, device),
        "wi_up": randn(gen, leading + (n_experts, d_model, d_expert), dtype,
                       s_in, device),
        "wo": randn(gen, leading + (n_experts, d_expert, d_model), dtype,
                    s_out, device),
    }


def moe_route(probs: torch.Tensor, top_k: int):
    """Top-k routing of ``probs`` [T, E]: returns ``(gate [T, k] f32,
    expert [T, k], perm [T*k], offsets [E], counts [E])``.

    The top k come from a stable descending sort, so that of two equal
    probabilities the lower expert index comes first, as ``jax.lax.top_k``
    returns them (``torch.topk`` promises no order). The gate is
    renormalised by max(sum, 1e-9). ``perm`` sorts the flattened (token, k)
    pairs by expert, stably: pair ``perm[j]`` lands at row ``j``, so expert
    e's pairs fill rows ``offsets[e] .. offsets[e] + counts[e] - 1`` in
    flattened (t, k) order, and a pair's place in that range is its position
    in the expert's queue (the reference's cumsum). Everything stays on the
    device: no host sync."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    expert = idx[:, :top_k]
    sorted_e, perm = torch.sort(expert.reshape(-1), stable=True)
    ids = torch.arange(probs.shape[-1], device=probs.device,
                       dtype=sorted_e.dtype)
    offsets = torch.searchsorted(sorted_e, ids)
    counts = torch.searchsorted(sorted_e, ids, right=True) - offsets
    return gate, expert, perm, offsets, counts


def moe_block(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float | None = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing with per-expert capacity (GShard-style);
    the reference's function, step for step: f32 router logits, softmax,
    top-k (:func:`moe_route`), each (token, k)'s position in its expert's
    queue in flattened (t, k) order, ``keep = pos < C`` with
    ``C = max(1, int(capacity_factor * T * top_k / n_experts))``, the
    combine in ``x.dtype`` summed over k, and the Switch aux loss.
    ``capacity_factor=None`` is dropless. Returns ``(output, aux_loss)``.

    The layout is the port's own. The reference dispatches into an
    ``[E, C + 1, D]`` buffer (``[E, T*k + 1, D]`` when dropless: 9.7 GB at a
    serving prefill of moonshot-16b) and multiplies every slot. Here the
    routed rows are gathered into one ``[T*k, D]`` buffer sorted by expert
    and go through three grouped matmuls (gate, up, down; silu * up between
    them in ``x.dtype``), whose per-expert offsets and counts stay on the
    device; the rows are gathered back to (t, k) order. The f32 router
    logits are rounded from an f64 product, so that a token's experts do
    not depend on the other rows of its batch. With a capacity, a
    pair whose position is C or more is simply not routed: its expert's
    count is cut to C, so the kernel neither reads nor writes its row."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    # through f64: cuBLAS's f32 product sums a row in an order that depends
    # on the number of rows, which could move a token to other experts
    logits = (xt.double() @ p["router"].double()).float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    gate, expert, perm, offsets, counts_all = moe_route(probs, top_k)
    counts = counts_all
    if capacity_factor is not None:
        C = max(1, int(capacity_factor * T * top_k / n_experts))
        counts = counts_all.clamp(max=C)
        rows = torch.arange(T * top_k, device=x.device)
        pos = torch.empty_like(perm).index_copy_(
            0, perm, rows - offsets[expert.reshape(-1)[perm]])
        keep = (pos < C).view(T, top_k)
        gate = gate * keep
    off32, cnt32 = offsets.int(), counts.int()
    xs = xt[perm // top_k]                                       # [T*k, D]
    h = F.silu(grouped_matmul(xs, p["wi_gate"], off32, cnt32)) \
        * grouped_matmul(xs, p["wi_up"], off32, cnt32)
    y_rows = grouped_matmul(h, p["wo"], off32, cnt32)
    y_pairs = torch.empty_like(y_rows).index_copy_(0, perm, y_rows)
    if capacity_factor is not None:     # dropped rows were never computed
        y_pairs = y_pairs.masked_fill(~keep.view(-1, 1), 0)
    y = (y_pairs.view(T, top_k, D) * gate.to(x.dtype)[..., None]).sum(dim=1)

    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    frac_tokens = counts_all.float() / (T * top_k)
    aux = n_experts * (frac_tokens * probs.mean(dim=0)).sum()
    return y.reshape(B, S, D), aux
