"""Transformer building blocks (plain functions on tensors).

The port of ``repro/models/layers.py``: same names, call signatures and the
``[B, S, H, Dh]`` attention layout. Three of them go to the port's Hopper
kernels on a CUDA tensor: :func:`rmsnorm` (``kernels/rmsnorm``),
:func:`blockwise_attention` (``kernels/flash_attention``) and the expert
products of :func:`moe_block` (``kernels/moe_gmm``); on a CPU tensor each
wrapper computes its kernel's plain version. Everything else is plain
torch, as the reference computes it outside any Pallas kernel.

Gradients: :func:`rmsnorm`, :func:`blockwise_attention`, the grouped
matmul, the SSD scan and WKV6 go through ``autograd.Function``s whose
backward is a kernel too on CUDA (``RMSNormFn``, ``FlashAttentionFn``,
``GroupedMatmulFn``, ``SSDScanFn``, ``WKV6Fn``). On the CPU the last three
stay plain torch and differentiable.

Parameters are dicts of tensors with the reference's keys. ``*_init``
functions draw with the reference's distributions and scales from an
explicit ``torch.Generator`` onto ``device`` (default CUDA); the bits differ
from the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.flash_attention.ops import (FlashAttentionFn, NEG_INF,
                                           flash_attention)
from ..kernels.moe_gmm.ops import grouped_matmul
from ..kernels.plain_grad import needs_grad
from ..kernels.rmsnorm.ops import RMSNormFn, rmsnorm as _rmsnorm_kernel
from ..sharding.rules import (active_mesh, constrain, merge_last, meshed,
                              split_dim, split_last)

__all__ = ["rmsnorm", "layernorm", "rope", "blockwise_attention",
           "decode_attention", "decode_attention_q8", "AttnParamsSpec",
           "attention_block", "decode_qkv", "cache_put",
           "decode_attention_block", "swiglu_mlp", "gelu_mlp", "mlp_init", "moe_init",
           "moe_route", "moe_block", "randn"]


def _local():
    """The kernels' meshed call sites (imports ``torch.distributed``; only
    reached under an active mesh)."""
    from ..sharding import local
    return local


def randn(gen: torch.Generator, shape, dtype: torch.dtype, scale: float,
          device=None) -> torch.Tensor:
    """``normal(shape) * scale`` drawn from ``gen`` on ``device`` (default
    CUDA). The draw happens on the generator's device; on the meta device
    nothing is drawn."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
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
    if active_mesh() is not None and meshed(x):
        return _local().rmsnorm(_rmsnorm, x, gamma, eps)
    if needs_grad(x, gamma):
        return RMSNormFn.apply(x, gamma, eps)
    return _rmsnorm_kernel(x, gamma, eps=eps)


def _rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    """The norm on plain tensors (a local shard under a mesh)."""
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
    if meshed(q):
        return _local().attention(_attention, q, k, v, causal, int(q_offset))
    return _attention(q, k, v, causal, int(q_offset))


def _attention(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
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
    """One-token attention against a [B, Smax, Hkv, Dh] cache. Under a
    mesh of more than one device it runs on the cache's local shards
    (``sharding.local.decode_attention``)."""
    if meshed(k_cache) and k_cache.device_mesh.size() > 1:
        return _local().decode_attention(q, k_cache, v_cache, cache_len,
                                         NEG_INF)
    B, Sq, Hq, Dh = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = split_dim(q, 2, Hkv).reshape(B, Sq, Hkv, G, Dh)
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
    qg = split_dim(q, 2, Hkv).reshape(B, Sq, Hkv, G, Dh).float()
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
    q = split_last(_proj(x, p, "wq", "bq"), B, S, n_heads, d_head)
    k = split_last(_proj(src, p, "wk", "bk"), B, Skv, n_kv_heads, d_head)
    v = split_last(_proj(src, p, "wv", "bv"), B, Skv, n_kv_heads, d_head)
    # head-sharded attention (Megatron TP) keeps the whole attention local
    # per device; constrain is the identity un-meshed or when the heads do
    # not divide 'model'
    q = constrain(q, ("pod", "data"), None, "model", None, require="model")
    k = constrain(k, ("pod", "data"), None, "model", None, require="model")
    v = constrain(v, ("pod", "data"), None, "model", None, require="model")
    if kv is None and rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    o = blockwise_attention(q, k, v, causal=causal and kv is None,
                            block_kv=block_kv)
    o = constrain(o, ("pod", "data"), None, "model", None, require="model")
    return _batch_sharded(merge_last(o, B, S, n_heads * d_head) @ p["wo"])


_BATCH = (("pod", "data"), None, None)


def _batch_sharded(y: torch.Tensor) -> torch.Tensor:
    """A block's output [B, S, D] placed by batch alone before its
    residual add: the add's gradient then comes back to the product that
    made ``y`` with its sequence whole, so that the product's backward
    flattens no sharded sequence. The identity un-meshed."""
    return constrain(y, *_BATCH)


def decode_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, *,
               n_heads: int, n_kv_heads: int, d_head: int,
               rope_theta: float) -> tuple[torch.Tensor, ...]:
    """One token a row: x [B, 1, D] at ``positions`` [B, 1] → q
    [B, 1, Hq, Dh] and k, v [B, 1, Hkv, Dh], RoPE applied when
    ``rope_theta``."""
    B = x.shape[0]
    q = split_last(_proj(x, p, "wq", "bq"), B, 1, n_heads, d_head)
    k = split_last(_proj(x, p, "wk", "bk"), B, 1, n_kv_heads, d_head)
    v = split_last(_proj(x, p, "wv", "bv"), B, 1, n_kv_heads, d_head)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def cache_put(buf: torch.Tensor, upd: torch.Tensor,
              at: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Write ``upd[sel, 0]`` into a layer's cache ``buf`` [B, Smax, ...]
    in place, at ``at = (sel, lens[sel])``: each row ``sel`` at its own
    position; the other rows stay untouched. Returns ``buf``. Under a mesh
    every row writes (``sel`` is all of them) into its local shard
    (``sharding.local.cache_put``)."""
    if meshed(buf):
        return _local().cache_put(buf, upd, at[1])
    buf.index_put_(at, upd[at[0], 0])
    return buf


def decode_attention_block(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lens: torch.Tensor,
                           sel: torch.Tensor, *, n_heads: int,
                           n_kv_heads: int, d_head: int,
                           rope_theta: float) -> torch.Tensor:
    """One-token self-attention against a layer's [B, Smax, Hkv, Dh]
    cache: the token of row b sits at position ``lens[b]``; rows ``sel``
    write its K/V there (:func:`cache_put`) and every row attends to its
    first ``lens + 1`` entries. Returns the output projection [B, 1, D]."""
    q, k, v = decode_qkv(p, x, lens[:, None], n_heads=n_heads,
                         n_kv_heads=n_kv_heads, d_head=d_head,
                         rope_theta=rope_theta)
    at = (sel, lens[sel])
    o = decode_attention(q, cache_put(k_cache, k, at),
                         cache_put(v_cache, v, at), lens + 1)
    return o.reshape(x.shape[0], 1, n_heads * d_head) @ p["wo"]


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return _batch_sharded(
        (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"])


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(_proj(x, p, "wi", "bi"), approximate="tanh")
    return _batch_sharded(_proj(h, p, "wo", "bo"))


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
    count is cut to C, so the kernel neither reads nor writes its row.

    Under a mesh (``sharding.local.moe_experts``) each rank routes only its
    own tokens and computes only the rows of its experts; its place in each
    expert's queue comes from the per-expert counts of the ranks before it,
    so the pairs dropped are the un-meshed ones. The output and the aux loss
    are partial sums over the mesh dimensions that split the experts (or
    share the tokens)."""
    args = (x, p["router"], p["wi_gate"], p["wi_up"], p["wo"])
    fn = functools.partial(_moe_rows, n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor)
    if meshed(x):
        y, aux = _local().moe_experts(fn, *args, n_experts)
        return _batch_sharded(y), aux
    return fn(*args, None)


def _moe_dispatch(probs, top_k: int, n_experts: int,
                  capacity_factor: float | None, n_tokens: int, shard):
    """Routing of the rows of ``probs`` [T, E] (:func:`moe_route`) and each
    pair's place in its expert's queue: ``(gate, expert, perm, offsets,
    counts_all, counts, keep, total)``. ``counts`` [E] are the pairs each
    expert computes, the first of its rows: all of them, or with a capacity
    ``C = max(1, int(capacity_factor * n_tokens * top_k / n_experts))``
    those whose place is below C (``keep`` [T, k]; None when dropless).
    ``total`` [E] counts the pairs of all ``n_tokens``. Under a mesh
    ``shard.exchange`` gives the pairs that the ranks before this one hold
    (their tokens come first in flattened order) and all ranks' pairs."""
    gate, expert, perm, offsets, counts_all = moe_route(probs, top_k)
    lo, total = (None, counts_all) if shard is None else \
        shard.exchange(counts_all)
    counts, keep = counts_all, None
    if capacity_factor is not None:
        C = max(1, int(capacity_factor * n_tokens * top_k / n_experts))
        sorted_e = expert.reshape(-1)[perm]
        place = torch.arange(perm.shape[0], device=perm.device) \
            - offsets[sorted_e]
        if lo is None:
            counts = counts_all.clamp(max=C)
        else:
            place = place + lo[sorted_e]
            counts = torch.minimum(counts_all, (C - lo).clamp(min=0))
        pos = torch.empty_like(perm).index_copy_(0, perm, place)
        keep = (pos < C).view(expert.shape)
        gate = gate * keep
    return gate, expert, perm, offsets, counts_all, counts, keep, total


def _moe_rows(x, router, wi_gate, wi_up, wo, shard, *, n_experts: int,
              top_k: int, capacity_factor: float | None):
    """:func:`moe_block` on plain tensors. ``shard``
    (``sharding.local.MoEShard``) is this rank's part under a mesh: the
    window ``[w0, w1)`` of x's flattened tokens that it routes, its experts
    ``[e0, e1)``, the batch's token count and the count exchange; the
    output is x's shape, zero outside the window, and the aux loss this
    part's share. ``None`` is the whole batch and every expert."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    T, e0, e1 = B * S, 0, n_experts
    if shard is not None:
        T, (e0, e1) = shard.n_tokens, shard.experts
        xt = xt[shard.window[0]:shard.window[1]]
    Tw, P = xt.shape[0], xt.shape[0] * top_k
    # through f64: cuBLAS's f32 product sums a row in an order that depends
    # on the number of rows, which could move a token to other experts
    logits = (xt.double() @ router.double()).float()
    probs = torch.softmax(logits, dim=-1)                        # [Tw, E]
    gate, expert, perm, offsets, counts_all, counts, keep, total = \
        _moe_dispatch(probs, top_k, n_experts, capacity_factor, T, shard)
    frac_tokens = total.float() / (T * top_k)
    every = (e0, e1) == (0, n_experts)
    src, off32, cnt32, rows = perm, offsets.int(), counts.int(), None
    if not every:
        # experts [e0, e1) hold the sorted rows start .. end - 1; a token
        # picks each expert once, so there are at most Tw * (e1 - e0)
        start = offsets[e0]
        end = offsets[e1 - 1] + counts_all[e1 - 1]
        j = start + torch.arange(min(P, Tw * (e1 - e0)), device=x.device)
        inside = j < end
        src = perm[j.clamp(max=P - 1)]
        off32, cnt32 = (offsets[e0:e1] - start).int(), counts[e0:e1].int()
        rows = P * (e1 - e0) // n_experts   # counted on shape-only tensors
    xs = xt[src // top_k]                        # [P or fewer rows, D]
    h = F.silu(grouped_matmul(xs, wi_gate, off32, cnt32, rows=rows)) \
        * grouped_matmul(xs, wi_up, off32, cnt32, rows=rows)
    y_rows = grouped_matmul(h, wo, off32, cnt32, rows=rows)
    if every:
        y_pairs = torch.empty_like(y_rows).index_copy_(0, perm, y_rows)
    else:       # the rows past ``end`` (never computed) go to a spare row
        y_pairs = y_rows.new_zeros(P + 1, D).index_copy_(
            0, torch.where(inside, src, P), y_rows)[:P]
    if keep is not None:                # dropped rows were never computed
        y_pairs = y_pairs.masked_fill(~keep.view(-1, 1), 0)
    y = (y_pairs.view(Tw, top_k, D) * gate.to(x.dtype)[..., None]).sum(dim=1)

    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    if shard is None:
        aux = n_experts * (frac_tokens * probs.mean(dim=0)).sum()
        return y.reshape(B, S, D), aux
    aux = n_experts * (frac_tokens[e0:e1]
                       * probs[:, e0:e1].sum(dim=0) / T).sum()
    w0, w1 = shard.window
    y = F.pad(y, (0, 0, w0, B * S - w1))
    return y.reshape(B, S, D), aux
