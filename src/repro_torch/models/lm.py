"""Decoder LM, dense family: the port of ``repro/models/lm.py``.

Parameters are a dict of tensors with the reference's pytree keys; the
per-layer leaves under ``params["layers"]`` are stacked ``[L, ...]`` and a
layer is ``leaf[i]`` (a view), walked by a Python loop where the reference
scans. The decode cache keeps the reference's ``init_cache`` layout
``[L, B, S_max, ...]``.

Differences from the reference, on purpose:

* ``decode_step`` writes the new K/V into the cache **in place**, and only
  at each active row's ``lens`` position; inert rows write nothing. The
  reference's functional update would copy the whole cache (4 GiB for
  llama-7b at batch 8 and 1024 tokens) on every step. The returned cache is
  the same dict of tensors that was passed in.
* The norms and the prefill attention go to the port's Hopper kernels on
  CUDA (``layers.rmsnorm``, ``layers.blockwise_attention``): per forward,
  ``2L + 1`` rmsnorm launches and, in ``prefill`` and ``apply``, ``L``
  flash-attention launches.
* ``init`` draws from an explicit ``torch.Generator``; the bits differ from
  the reference's ``jax.random``. Carry the reference's parameters across
  with :func:`repro_torch.core.bridge.params_from_reference` to compute the
  same function.

``remat``, ``loss`` and the MoE, RWKV and Zamba2 families wait for later
slices.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from . import layers as L

__all__ = ["LM"]

_KV_DTYPES = ("bf16", "int8")


def _norm(cfg: ArchConfig, p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return L.rmsnorm(x, p[key + "_g"])
    if cfg.norm == "layernorm":
        return L.layernorm(x, p[key + "_g"], p[key + "_b"])
    return L.layernorm(x, None, None)       # layernorm_np (OLMo)


def _norm_init(cfg: ArchConfig, d: int, dtype, leading=(), device=None) -> dict:
    dev = resolve_device(device)
    if cfg.norm == "rmsnorm":
        return {"_g": torch.ones(leading + (d,), dtype=dtype, device=dev)}
    if cfg.norm == "layernorm":
        return {"_g": torch.ones(leading + (d,), dtype=dtype, device=dev),
                "_b": torch.zeros(leading + (d,), dtype=dtype, device=dev)}
    return {}


def _with_prefix(prefix: str, d: dict) -> dict:
    return {prefix + k: v for k, v in d.items()}


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization over the last axis:
    returns (int8 values, f32 scales without the last axis)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


class LM:
    """Decoder-only LM, dense family, on ``device`` (default CUDA)."""

    def __init__(self, cfg: ArchConfig, *, kv_cache_dtype: str = "bf16",
                 device=None) -> None:
        if cfg.family != "dense":
            raise ValueError(f"the port's LM runs the dense family; "
                             f"{cfg.family!r} waits for a later slice")
        if kv_cache_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {_KV_DTYPES}")
        self.cfg = cfg
        self.kv_cache_dtype = kv_cache_dtype
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> dict:
        """Random parameters with the reference's distributions and scales,
        drawn from ``gen`` (on the generator's device) onto the model's
        device."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        Vp, D, Ln = cfg.padded_vocab, cfg.d_model, (cfg.n_layers,)
        params: dict[str, Any] = {
            "embed": L.randn(gen, (Vp, D), dt, 0.02, dev),
            "unembed": L.randn(gen, (D, Vp), dt, 1.0 / math.sqrt(D), dev),
        }
        params.update(_with_prefix("ln_f", _norm_init(cfg, D, dt,
                                                      device=dev)))
        spec = L.AttnParamsSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, cfg.qkv_bias)
        lp: dict[str, Any] = {"attn": spec.init(gen, dt, leading=Ln,
                                                device=dev)}
        lp.update(_with_prefix("ln1", _norm_init(cfg, D, dt, Ln, dev)))
        lp.update(_with_prefix("ln2", _norm_init(cfg, D, dt, Ln, dev)))
        lp["mlp"] = L.mlp_init(gen, D, cfg.d_ff, cfg.mlp, dt,
                               bias=(cfg.mlp == "gelu"), leading=Ln,
                               device=dev)
        params["layers"] = lp
        return params

    # ------------------------------------------------------------ blocks
    def _mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.mlp == "swiglu":
            return L.swiglu_mlp(p["mlp"], x)
        return L.gelu_mlp(p["mlp"], x)

    def _attn_mlp_block(self, p: dict, h: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _norm(cfg, p, "ln1", h)
        h = h + L.attention_block(
            p["attn"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, positions=positions,
            rope_theta=cfg.rope_theta)
        return h + self._mlp(p, _norm(cfg, p, "ln2", h))

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device)[None].expand(B, S)

    # ------------------------------------------------------------- apply
    def apply(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward: tokens [B, S] → logits [B, S, padded_vocab]."""
        B, S = tokens.shape
        h = params["embed"][tokens]
        positions = self._positions(B, S)
        for i in range(self.cfg.n_layers):
            h = self._attn_mlp_block(layer_params(params["layers"], i), h,
                                     positions)
        h = _norm(self.cfg, params, "ln_f", h)
        return h @ params["unembed"]

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        if self.kv_cache_dtype == "int8":
            # per-(token, head) scales: KIVI-style post-RoPE int8 KV
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
            }
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def prefill(self, params: dict, tokens: torch.Tensor,
                lengths: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Batched prompt ingestion: ONE forward over [B, S]. Returns
        ``(last_logits, kv)``: ``last_logits`` [B, padded_vocab] at each
        row's last prompt token (position ``lengths - 1``) and ``kv``'s
        leaves stacked [L, B, S, ...] in ``init_cache`` layout over the
        token slice [0, S). Rows may be ragged: positions past a row's
        length hold junk K/V that later per-row ``cache_len`` masking never
        attends."""
        cfg = self.cfg
        B, S = tokens.shape
        K, Dh = cfg.n_kv_heads, cfg.d_head
        h = params["embed"][tokens]
        positions = self._positions(B, S)
        ks = torch.empty((cfg.n_layers, B, S, K, Dh), dtype=h.dtype,
                         device=h.device)
        vs = torch.empty_like(ks)
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            x = _norm(cfg, lp, "ln1", h)
            pa = lp["attn"]
            q = L._proj(x, pa, "wq", "bq").reshape(B, S, cfg.n_heads, Dh)
            k = L._proj(x, pa, "wk", "bk").reshape(B, S, K, Dh)
            v = L._proj(x, pa, "wv", "bv").reshape(B, S, K, Dh)
            if cfg.rope_theta:
                q = L.rope(q, positions, cfg.rope_theta)
                k = L.rope(k, positions, cfg.rope_theta)
            ks[i].copy_(k)
            vs[i].copy_(v)
            o = L.blockwise_attention(q, k, v, causal=True)
            h = h + o.reshape(B, S, cfg.n_heads * Dh) @ pa["wo"]
            h = h + self._mlp(lp, _norm(cfg, lp, "ln2", h))
        h = _norm(cfg, params, "ln_f", h)
        rows = torch.arange(B, device=h.device)
        last = h[rows, (lengths.to(h.device) - 1).clamp_min(0)]   # [B, D]
        logits = last @ params["unembed"]
        if self.kv_cache_dtype == "int8":
            kq, ksc = _quant_int8(ks)
            vq, vsc = _quant_int8(vs)
            return logits, {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
        return logits, {"k": ks, "v": vs}

    def _attn_decode_block(self, p: dict, h: torch.Tensor, cache: dict,
                           layer: int, lens: torch.Tensor,
                           sel: torch.Tensor) -> torch.Tensor:
        """One-token attention + MLP. ``lens`` [B] is each row's cache
        length: the row writes this token at its own position. Only rows
        ``sel`` write; the others leave the cache untouched."""
        cfg = self.cfg
        B = h.shape[0]
        x = _norm(cfg, p, "ln1", h)
        pa = p["attn"]
        q = L._proj(x, pa, "wq", "bq").reshape(B, 1, cfg.n_heads, cfg.d_head)
        k = L._proj(x, pa, "wk", "bk").reshape(B, 1, cfg.n_kv_heads,
                                               cfg.d_head)
        v = L._proj(x, pa, "wv", "bv").reshape(B, 1, cfg.n_kv_heads,
                                               cfg.d_head)
        pos = lens[:, None]
        if cfg.rope_theta:
            q = L.rope(q, pos, cfg.rope_theta)
            k = L.rope(k, pos, cfg.rope_theta)
        at = (sel, lens[sel])

        def put(name: str, upd: torch.Tensor) -> torch.Tensor:
            buf = cache[name][layer]
            buf.index_put_(at, upd[sel, 0])
            return buf

        if self.kv_cache_dtype == "int8":
            kq, ksc = _quant_int8(k)
            vq, vsc = _quant_int8(v)
            o = L.decode_attention_q8(q, put("k", kq), put("v", vq),
                                      put("k_scale", ksc),
                                      put("v_scale", vsc), lens + 1)
        else:
            o = L.decode_attention(q, put("k", k), put("v", v), lens + 1)
        h = h + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ pa["wo"]
        return h + self._mlp(p, _norm(cfg, p, "ln2", h))

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    cache_len, active: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode. token: [B, 1] → logits [B, padded_vocab].

        ``cache_len`` is an int (all rows at the same depth) or per-row [B]
        (a ragged continuous-batching step). ``active`` is an optional [B]
        bool mask: rows that are False write nothing into the cache; their
        logits are garbage and the caller must ignore them. The cache is
        updated in place, at each active row's own position, and returned."""
        B = token.shape[0]
        dev = self.device
        lens = torch.as_tensor(cache_len, dtype=torch.int64,
                               device=dev).reshape(-1).expand(B)
        sel = (torch.arange(B, device=dev) if active is None
               else torch.nonzero(torch.as_tensor(active, device=dev)
                                  ).flatten())
        h = params["embed"][token]                         # [B, 1, D]
        for i in range(self.cfg.n_layers):
            h = self._attn_decode_block(layer_params(params["layers"], i), h,
                                        cache, i, lens, sel)
        h = _norm(self.cfg, params, "ln_f", h)
        return (h @ params["unembed"])[:, 0], cache
