"""Encoder-decoder backbone (seamless-m4t-large-v2): the port of
``repro/models/encdec.py``.

The audio frontend (a conformer speech encoder) is a stub, as in the
reference: ``encode`` takes precomputed frame embeddings [B, S_enc, D].
The backbone is a bidirectional encoder over them (RoPE, no mask) and a
causal decoder whose layers attend to the encoder's output (cross-
attention without RoPE or mask).

The parameter tree is the reference's: ``embed``, ``unembed``,
``enc_layers`` (``attn``, ``mlp`` with ``wi``/``bi``/``wo``/``bo``,
``ln1``, ``ln2``) and ``dec_layers`` (``self_attn``, ``cross_attn``,
``mlp``, ``ln1``-``ln3``) stacked ``[L, ...]``, ``ln_enc`` and ``ln_f``;
so :func:`repro_torch.core.bridge.params_from_reference` carries the
reference's weights across unchanged. ``init`` draws from an explicit
``torch.Generator``; the bits differ from the reference's ``jax.random``.

Layers are the port's (``layers.attention_block``, the norms and MLPs of
``models/lm.py``): on CUDA every attention, self and cross, goes to the
flash-attention kernel and its backward kernels, one launch per attention
per forward (``L_enc`` per ``encode``, ``2 L_dec`` per ``decode``), and in
``decode_step`` the cross-attention (one query row) does too while the
self-attention reads the cache in plain torch (``layers.decode_attention``).
``remat`` takes the reference's modes: None, ``'offload'`` (each layer's
input to pinned host memory, :mod:`.offload`) and any other value, a full
checkpoint of each layer.

Differences from the reference, on purpose: ``decode_step`` writes the new
K/V into the cache in place and returns the same dict. As in the reference,
the cross-attention's K/V are recomputed from ``enc_out`` at every step and
one ``cache_len`` serves the batch.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..sharding.rules import constrain, embed_rows, unembed
from . import layers as L
from .lm import (_norm, _norm_init, _with_prefix, layer_params, positions,
                 token_nll, wrap_remat)
from .offload import ResidualOffload

__all__ = ["EncDec"]


class EncDec:
    """The enc-dec model on ``device`` (default CUDA)."""

    def __init__(self, cfg: ArchConfig, *, remat: str | None = None,
                 device=None) -> None:
        if cfg.family != "encdec":
            raise ValueError(f"EncDec runs the encdec family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.remat = remat
        self.device = resolve_device(device)

    def _wrap_remat(self, body, off: ResidualOffload | None):
        mode = (self.remat if self.remat in (None, "offload") else "full")
        return wrap_remat(body, mode, off)

    def _offload(self) -> ResidualOffload | None:
        return (ResidualOffload(self.device) if self.remat == "offload"
                else None)

    # ------------------------------------------------------------- params
    def _layer_init(self, gen: torch.Generator, attn: tuple[str, ...],
                    norms: tuple[str, ...], n: int) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        D, lead = cfg.d_model, (n,)
        spec = L.AttnParamsSpec(D, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                cfg.qkv_bias)
        p: dict[str, Any] = {a: spec.init(gen, dt, leading=lead, device=dev)
                             for a in attn}
        p["mlp"] = L.mlp_init(gen, D, cfg.d_ff, cfg.mlp, dt,
                              bias=(cfg.mlp == "gelu"), leading=lead,
                              device=dev)
        for nm in norms:
            p.update(_with_prefix(nm, _norm_init(cfg, D, dt, lead, dev)))
        return p

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters with the reference's distributions and scales,
        drawn from ``gen`` onto the model's device."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        Vp, D = cfg.padded_vocab, cfg.d_model
        params: dict[str, Any] = {
            "embed": L.randn(gen, (Vp, D), dt, 0.02, dev),
            "unembed": L.randn(gen, (D, Vp), dt, 1.0 / math.sqrt(D), dev),
            "enc_layers": self._layer_init(gen, ("attn",), ("ln1", "ln2"),
                                           cfg.n_layers),
            "dec_layers": self._layer_init(
                gen, ("self_attn", "cross_attn"), ("ln1", "ln2", "ln3"),
                cfg.n_decoder_layers),
        }
        params.update(_with_prefix("ln_enc", _norm_init(cfg, D, dt,
                                                        device=dev)))
        params.update(_with_prefix("ln_f", _norm_init(cfg, D, dt,
                                                      device=dev)))
        return params

    # ------------------------------------------------------------- blocks
    def _mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.mlp == "swiglu":
            return L.swiglu_mlp(p["mlp"], x)
        return L.gelu_mlp(p["mlp"], x)

    def _attn(self, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool, kv: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        return L.attention_block(
            p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, positions=positions, causal=causal,
            rope_theta=cfg.rope_theta if kv is None else 0.0, kv=kv)

    def _cross_mlp(self, lp: dict, h: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """A decoder layer after its self-attention: cross-attention over
        ``enc_out`` and the MLP, each behind its norm."""
        cfg = self.cfg
        h = h + self._attn(lp["cross_attn"], _norm(cfg, lp, "ln2", h),
                           positions, causal=False, kv=enc_out)
        return h + self._mlp(lp, _norm(cfg, lp, "ln3", h))

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return positions(B, S, self.device)

    # -------------------------------------------------------------- apply
    def encode(self, params: dict, encoder_embeds) -> torch.Tensor:
        """Frame embeddings [B, S_enc, D] (a tensor or an array) → the
        encoder's output [B, S_enc, D] in the model's dtype."""
        cfg = self.cfg
        h = torch.as_tensor(encoder_embeds, device=self.device).to(self.dtype)
        positions = self._positions(*h.shape[:2])

        def body(hh, i):
            lp = layer_params(params["enc_layers"], i)
            hh = hh + self._attn(lp["attn"], _norm(cfg, lp, "ln1", hh),
                                 positions, causal=False)
            hh = hh + self._mlp(lp, _norm(cfg, lp, "ln2", hh))
            return constrain(hh, ("pod", "data"), "model", None)  # SP
        body = self._wrap_remat(body, self._offload())
        for i in range(cfg.n_layers):
            h = body(h, i)
        return _norm(cfg, params, "ln_enc", h)

    def decode(self, params: dict, enc_out: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: tokens [B, S] over ``enc_out`` → logits
        [B, S, padded_vocab]."""
        cfg = self.cfg
        h = embed_rows(params["embed"], torch.as_tensor(
            tokens, device=self.device).long())
        h = constrain(h, ("pod", "data"), None, None)
        positions = self._positions(*h.shape[:2])

        def body(hh, i):
            lp = layer_params(params["dec_layers"], i)
            hh = hh + self._attn(lp["self_attn"], _norm(cfg, lp, "ln1", hh),
                                 positions, causal=True)
            hh = self._cross_mlp(lp, hh, enc_out, positions)
            return constrain(hh, ("pod", "data"), "model", None)  # SP
        body = self._wrap_remat(body, self._offload())
        for i in range(cfg.n_decoder_layers):
            h = body(h, i)
        # the norm gathers the sequence before the head (``LM.apply``)
        return unembed(_norm(cfg, params, "ln_f", h), params["unembed"])

    def apply(self, params: dict, tokens: torch.Tensor, *,
              encoder_embeds) -> torch.Tensor:
        return self.decode(params, self.encode(params, encoder_embeds),
                           tokens)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean NLL of ``batch["labels"]`` under ``apply`` of
        ``batch["tokens"]`` and ``batch["encoder_embeds"]`` (tensors or
        arrays), over the true vocabulary, in f32 (the reference's
        ``loss``: the vocab padding masked with −1e30)."""
        cfg = self.cfg
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        logits = self.apply(params, batch["tokens"],
                            encoder_embeds=batch["encoder_embeds"]).float()
        return token_nll(logits, labels, cfg.vocab_size).mean()

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, enc_len: int) -> dict:
        """``enc_out`` [B, enc_len, D] (the caller writes the encoder's
        output there) and the decoder's self-attention K/V
        [L_dec, B, max_len, K, Dh], zeros in the model's dtype."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        kv = (cfg.n_decoder_layers, batch, max_len, cfg.n_kv_heads,
              cfg.d_head)
        return {"enc_out": torch.zeros((batch, enc_len, cfg.d_model),
                                       dtype=dt, device=dev),
                "k": torch.zeros(kv, dtype=dt, device=dev),
                "v": torch.zeros(kv, dtype=dt, device=dev)}

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    cache_len) -> tuple[torch.Tensor, dict]:
        """One decoder token per row: token [B, 1] at position
        ``cache_len`` (an int, or a 0-d tensor, for the whole batch) →
        logits [B, padded_vocab]. The new K/V are written into
        ``cache`` in place, which is returned."""
        cfg, dev = self.cfg, self.device
        B = token.shape[0]
        h = embed_rows(params["embed"],
                       torch.as_tensor(token, device=dev).long())                      # [B, 1, D]
        # the encoder's output placed by batch alone: the cache rules shard
        # its sequence over 'model', which the K/V products would flatten
        # into their rows as a strided shard
        enc_out = constrain(cache["enc_out"], ("pod", "data"), None, None)
        lens = torch.full((B,), int(cache_len), dtype=torch.int64,
                          device=dev)
        rows = torch.arange(B, device=dev)
        for i in range(cfg.n_decoder_layers):
            lp = layer_params(params["dec_layers"], i)
            h = h + L.decode_attention_block(
                lp["self_attn"], _norm(cfg, lp, "ln1", h), cache["k"][i],
                cache["v"][i], lens, rows, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta)
            h = self._cross_mlp(lp, h, enc_out, lens[:, None])
        h = _norm(cfg, params, "ln_f", h)
        return (h @ params["unembed"])[:, 0], cache
