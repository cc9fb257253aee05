"""Transformer building blocks, dense parts (plain functions on tensors).

The port of ``repro/models/layers.py``: same names, call signatures and the
``[B, S, H, Dh]`` attention layout. Two of them go to the port's Hopper
kernels on a CUDA tensor: :func:`rmsnorm` (``kernels/rmsnorm``) and
:func:`blockwise_attention` (``kernels/flash_attention``); on a CPU tensor
each wrapper computes its kernel's plain version. Everything else is plain
torch, as the reference computes it outside any Pallas kernel.

Parameters are dicts of tensors with the reference's keys. ``*_init``
functions draw with the reference's distributions and scales from an
explicit ``torch.Generator`` onto ``device`` (default CUDA); the bits differ
from the reference's ``jax.random`` draws. The MoE block waits for the MoE
slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.flash_attention.ops import NEG_INF, flash_attention
from ..kernels.rmsnorm.ops import rmsnorm as _rmsnorm_kernel

__all__ = ["rmsnorm", "layernorm", "rope", "blockwise_attention",
           "decode_attention", "decode_attention_q8", "AttnParamsSpec",
           "attention_block", "swiglu_mlp", "gelu_mlp", "mlp_init", "randn"]


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
    accumulation, one rounding to x.dtype). Without ``gamma`` it is plain
    torch."""
    if gamma is None:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps).to(x.dtype)
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
    """Online-softmax attention over KV blocks: the flash-attention kernel.

    q: [B, Sq, Hq, Dh], k/v: [B, Skv, Hkv, Dh] with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0]. ``block_kv`` is the
    reference's XLA block size; the kernel keeps its own tiles, so it is
    accepted and not used."""
    del block_kv
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
