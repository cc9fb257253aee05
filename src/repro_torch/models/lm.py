"""Decoder LM, dense, MoE, RWKV6 and Zamba2-hybrid families: the port of
``repro/models/lm.py``.

Parameters are a dict of tensors with the reference's pytree keys; the
per-layer leaves under ``params["layers"]`` are stacked ``[L, ...]`` and a
layer is ``leaf[i]`` (a view), walked by a Python loop where the reference
scans. Zamba2's Mamba layers are stacked ``[ng, grp, ...]`` under
``params["mamba"]`` and ``[tail, ...]`` under ``params["mamba_tail"]``;
its one shared attention+MLP block (``params["shared"]``) is called before
each group, scaled by that call's ``shared_adapters[g]``. The decode cache
keeps the reference's ``init_cache`` layout: ``[L, B, S_max, ...]`` K/V,
RWKV's token shifts and f32 WKV states per layer, Zamba2's f32 SSM states,
conv windows and the shared block's K/V per group.

Differences from the reference, on purpose:

* ``decode_step`` writes the new K/V into the cache **in place**, and only
  at each active row's ``lens`` position; inert rows write nothing. The
  reference's functional update would copy the whole cache (4 GiB for
  llama-7b at batch 8 and 1024 tokens) on every step. The recurrent
  families' states are overwritten in place too. The returned cache is the
  same dict of tensors that was passed in.
* The norms, the prefill attention and the MoE experts go to the port's
  Hopper kernels on CUDA (``layers.rmsnorm``, ``layers.blockwise_attention``,
  ``layers.moe_block``): per forward, ``2L + 1`` rmsnorm launches, ``3L``
  grouped-matmul launches for the MoE family and, in ``prefill`` and
  ``apply``, ``L`` flash-attention launches. The recurrent families' sequence
  forward (``apply``) goes through the scan kernels: ``L`` wkv6 launches
  and ``L`` rmsnorm launches (``ln_x``; its block norms are layernorms)
  per rwkv forward; per zamba forward one ssd_scan launch per Mamba layer,
  one flash-attention launch per shared-block call, and one rmsnorm
  launch per Mamba layer plus two per shared call plus one.
* The MoE block routes only the (token, k) pairs it keeps, through ragged
  grouped matmuls (``layers.moe_block``), where the reference fills
  ``[E, C, D]`` dispatch buffers; ``prefill`` and ``decode_step`` run it
  dropless, as the reference does, with no host sync.
* ``init`` draws from an explicit ``torch.Generator``; the bits differ from
  the reference's ``jax.random``. Carry the reference's parameters across
  with :func:`repro_torch.core.bridge.params_from_reference` to compute the
  same function.

* ``loss`` is the reference's (``lm.py:255-271``): f32 logits, the vocab
  padding masked with −1e30, mean NLL, plus ``0.01·aux / n_layers`` for
  MoE. ``remat`` wraps each layer body as the reference's ``_wrap_remat``
  (``lm.py:74-93``) does, with ``torch.utils.checkpoint`` (non-reentrant):
  ``'full'`` keeps only the layer's input; ``'dots'`` also saves the
  outputs of the plain (unbatched) matrix products, ``aten.mm`` and
  ``aten.addmm``, as ``dots_with_no_batch_dims_saveable`` does; ``'offload'``
  keeps only the input and moves it to pinned host memory and back
  (:mod:`.offload`). Zamba2's shared block is recomputed in full whenever
  ``remat`` is set (reference :236-238). On CUDA a gradient goes through
  the rmsnorm and flash-attention backward kernels; through the MoE, SSD
  and WKV6 kernels, whose forward runs on the card, it goes through
  their plain versions, recomputed (every decoder family trains).

``prefill`` serves the attention families only, as in the reference: a
recurrent family's prompt pass is its decode loop. ``apply`` and ``loss``
of the dense and MoE families take a stub frontend's ``vision_embeds``
[B, F, D], prepended to the token embeddings (``loss`` drops their F
positions before the NLL); ``prefill`` and ``decode_step`` take none, as
in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..sharding.rules import (active_mesh, constrain, embed_rows,
                              fsdp_gather, meshed, shard_dim, unembed)
from ..spans import span, spanned
from . import layers as L
from . import rwkv as R
from . import ssm as SSM
from .offload import ResidualOffload

__all__ = ["LM", "REMAT_MODES", "token_nll", "positions"]

_KV_DTYPES = ("bf16", "int8")
_FAMILIES = ("dense", "moe", "rwkv", "zamba")
REMAT_MODES = (None, "full", "dots", "offload")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of unbatched matrix products, recompute the rest
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def wrap_remat(body, mode: str | None,
               off: ResidualOffload | None = None):
    """``body(h, *args)`` under the activation-checkpoint policy ``mode``
    (one of ``REMAT_MODES``); ``'offload'`` sends the layer's input
    ``h`` through ``off``. The body runs inside the span ``turnip.layer``,
    in the forward and in the recompute alike."""
    body = spanned("turnip.layer")(body)
    if mode is None:
        return body
    if mode == "full":
        return lambda h, *a: checkpoint(body, h, *a, use_reentrant=False)
    if mode == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda h, *a: checkpoint(body, h, *a, use_reentrant=False,
                                        context_fn=ctx)

    def offloaded(h, *a):
        with off.layer(h):
            return checkpoint(body, h, *a, use_reentrant=False)
    return offloaded


def _norm(cfg: ArchConfig, p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """The block's norm of ``x`` [B, S, D]. Under a mesh the norm runs on
    the sequence-parallel shards and its output is gathered over the
    sequence (Megatron's sequence parallelism), so that no product has to
    flatten a sharded sequence into its rows."""
    if cfg.norm == "rmsnorm":
        y = L.rmsnorm(x, p[key + "_g"])
    elif cfg.norm == "layernorm":
        y = L.layernorm(x, p[key + "_g"], p[key + "_b"])
    else:
        y = L.layernorm(x, None, None)      # layernorm_np (OLMo)
    return constrain(y, ("pod", "data"), None, None)


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


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """``-log softmax(logits)[label]`` per position, [..., 1], over the
    first ``vocab`` entries of f32 ``logits`` (the padding masked with
    −1e30, as the reference does). Where a mesh of more than one device
    shards the vocabulary, the log-sum-exp and the label's logit are
    reduced over the shards (vocabulary-parallel,
    ``sharding.local.token_nll``), so that no device holds a whole row of
    the vocabulary and the backward stays sharded; else ``log_softmax``
    and ``gather``."""
    if _vocab_sharded(logits):
        from ..sharding.local import token_nll as vocab_parallel
        return vocab_parallel(logits, labels, vocab)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits + torch.where(iota < vocab, 0.0, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])


def _vocab_sharded(logits: torch.Tensor) -> bool:
    if not meshed(logits):
        return False
    last = logits.dim() - 1
    mesh = logits.device_mesh
    return any(shard_dim(p) in (last, -1) and mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def positions(B: int, S: int, device) -> torch.Tensor:
    """The positions 0..S-1 of B rows, [B, S]. Under a mesh, one [1, S]
    row that the rows broadcast: a plain [B, S] tensor would meet the
    batch-sharded activations as a replicated one, and the rope tables
    made from it would hold every row of the batch on every device."""
    pos = torch.arange(S, device=device)[None]
    return pos if active_mesh() is not None else pos.expand(B, S)


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter tree (views; under a
    mesh their FSDP shards gathered, ``sharding.rules.fsdp_gather``)."""
    if active_mesh() is not None:
        return {k: layer_params(v, i) if isinstance(v, dict)
                else fsdp_gather(v[i]) for k, v in layers.items()}
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


class LM:
    """Decoder-only LM for the dense, moe, rwkv and zamba families, on
    ``device`` (default CUDA). ``moe_capacity_factor`` bounds each expert's
    queue in ``apply`` (None: dropless); ``prefill`` and ``decode_step`` are
    always dropless. ``kv_cache_dtype`` applies to the attention families;
    Zamba2's shared block keeps its K/V in the model's dtype, as in the
    reference."""

    def __init__(self, cfg: ArchConfig, *,
                 moe_capacity_factor: float | None = 1.25,
                 remat: str | None = None,
                 kv_cache_dtype: str = "bf16", device=None) -> None:
        if cfg.family not in _FAMILIES:
            raise ValueError(f"the port's LM runs the {_FAMILIES} families, "
                             f"not {cfg.family!r}")
        if kv_cache_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {_KV_DTYPES}")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.cfg = cfg
        self.moe_capacity_factor = moe_capacity_factor
        self.remat = remat
        self.kv_cache_dtype = kv_cache_dtype
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    def _wrap_remat(self, body, mode: str | None = None,
                    off: ResidualOffload | None = None):
        """``body(h, *args)`` under the activation-checkpoint policy
        ``mode`` (default: the model's ``remat``); ``'offload'`` sends the
        layer's input through ``off``, the apply's own offload."""
        return wrap_remat(body, self.remat if mode is None else mode, off)

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
        if cfg.family in ("dense", "moe"):
            params["layers"] = self._layer_init(gen, Ln)
        elif cfg.family == "rwkv":
            lp = R.rwkv6_init(gen, D, headdim=cfg.rwkv_headdim,
                              d_ff=cfg.d_ff, dtype=dt, leading=Ln,
                              device=dev)
            lp.update(_with_prefix("ln1", _norm_init(cfg, D, dt, Ln, dev)))
            lp.update(_with_prefix("ln2", _norm_init(cfg, D, dt, Ln, dev)))
            params["layers"] = lp
        else:                                             # zamba
            ng, grp, tail = self._zamba_split()
            kw = dict(d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                      expand=cfg.ssm_expand, dtype=dt, device=dev)
            params["mamba"] = SSM.ssd_init(gen, D, leading=(ng, grp), **kw)
            if tail:
                params["mamba_tail"] = SSM.ssd_init(gen, D, leading=(tail,),
                                                    **kw)
            params["shared"] = self._layer_init(gen, ())
            # per-call adapter: input-norm gains (Zamba2's per-call LoRA
            # simplified to a per-call scale, as in the reference)
            params["shared_adapters"] = torch.ones((ng, D), dtype=dt,
                                                   device=dev)
        return params

    def _layer_init(self, gen: torch.Generator, leading: tuple) -> dict:
        """An attention + MLP (or MoE) layer, ``leading`` dims first."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        D = cfg.d_model
        spec = L.AttnParamsSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, cfg.qkv_bias)
        lp: dict[str, Any] = {"attn": spec.init(gen, dt, leading=leading,
                                                device=dev)}
        lp.update(_with_prefix("ln1", _norm_init(cfg, D, dt, leading, dev)))
        lp.update(_with_prefix("ln2", _norm_init(cfg, D, dt, leading, dev)))
        if cfg.family == "moe":
            lp["moe"] = L.moe_init(gen, D, cfg.d_ff, cfg.n_experts, dt,
                                   leading=leading, device=dev)
        else:
            lp["mlp"] = L.mlp_init(gen, D, cfg.d_ff, cfg.mlp, dt,
                                   bias=(cfg.mlp == "gelu"), leading=leading,
                                   device=dev)
        return lp

    def _zamba_split(self) -> tuple[int, int, int]:
        """(groups, Mamba layers per group, Mamba layers in the tail)."""
        grp = self.cfg.zamba_group
        ng = self.cfg.n_layers // grp
        return ng, grp, self.cfg.n_layers - ng * grp

    # ------------------------------------------------------------ blocks
    def _ffn(self, p: dict, x: torch.Tensor,
             capacity_factor: float | None = None):
        """(the MLP's or the MoE block's output, the MoE aux loss or
        None)."""
        cfg = self.cfg
        if "moe" in p:
            return L.moe_block(p["moe"], x, n_experts=cfg.n_experts,
                               top_k=cfg.top_k,
                               capacity_factor=capacity_factor)
        if cfg.mlp == "swiglu":
            return L.swiglu_mlp(p["mlp"], x), None
        return L.gelu_mlp(p["mlp"], x), None

    def _attn_mlp_block(self, p: dict, h: torch.Tensor,
                        positions: torch.Tensor,
                        adapter_g: torch.Tensor | None = None):
        """(the block's output, the MoE aux loss or None)."""
        cfg = self.cfg
        x = _norm(cfg, p, "ln1", h)
        if adapter_g is not None:
            x = x * adapter_g
        h = h + L.attention_block(
            p["attn"], x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, positions=positions,
            rope_theta=cfg.rope_theta)
        y, aux = self._ffn(p, _norm(cfg, p, "ln2", h),
                           self.moe_capacity_factor)
        return h + y, aux

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return positions(B, S, self.device)

    # ------------------------------------------------------------- apply
    def apply(self, params: dict, tokens: torch.Tensor, *,
              vision_embeds=None) -> torch.Tensor:
        """Full forward: tokens [B, S] → logits [B, F + S, padded_vocab],
        where ``vision_embeds`` [B, F, D] (dense and MoE families; a tensor
        or an array) are prepended to the token embeddings in the
        activation dtype and the positions run over all F + S. Also sets
        ``self._aux``, the MoE aux loss summed over the layers.

        A layer's parameters are taken out of the stacked leaves inside
        its (recomputed) body, so that a leaf whose layer slice is computed
        (a LoRA merge, ``models/lora.py``) is recomputed with it."""
        cfg = self.cfg
        self._aux = torch.zeros((), dtype=torch.float32, device=self.device)
        off = (ResidualOffload(self.device) if self.remat == "offload"
               else None)
        h = embed_rows(params["embed"], tokens)
        if vision_embeds is not None:
            if cfg.family not in ("dense", "moe"):
                raise ValueError(f"a vision frontend feeds the dense and moe "
                                 f"families, not {cfg.family!r}")
            ve = torch.as_tensor(vision_embeds, device=self.device)
            h = torch.cat([ve.to(h.dtype), h], dim=1)
        h = constrain(h, ("pod", "data"), None, None)
        B, S = h.shape[:2]
        positions = self._positions(B, S)
        if cfg.family in ("dense", "moe"):
            def block(hh, i):
                hh, aux = self._attn_mlp_block(
                    layer_params(params["layers"], i), hh, positions)
                return constrain(hh, ("pod", "data"), "model", None), aux  # SP
            block = self._wrap_remat(block, off=off)
            for i in range(cfg.n_layers):
                h, aux = block(h, i)
                if aux is not None:
                    self._aux = self._aux + aux
        elif cfg.family == "rwkv":
            def body(hh, i):
                lp = layer_params(params["layers"], i)
                hh = hh + R.rwkv6_time_mix(lp, _norm(cfg, lp, "ln1", hh),
                                           headdim=cfg.rwkv_headdim)
                hh = hh + R.rwkv6_channel_mix(lp, _norm(cfg, lp, "ln2", hh))
                return constrain(hh, ("pod", "data"), "model", None)  # SP
            body = self._wrap_remat(body, off=off)
            for i in range(cfg.n_layers):
                h = body(h, i)
        else:                                             # zamba
            ng, grp, tail = self._zamba_split()

            def mamba(hh, key, *idx):
                lp = params[key]
                for j in idx:
                    lp = layer_params(lp, j)
                return constrain(hh + self._mamba(lp, hh),
                                 ("pod", "data"), "model", None)  # SP
            mamba = self._wrap_remat(mamba, off=off)

            def shared(hh, g):
                return self._attn_mlp_block(
                    params["shared"], hh, positions,
                    adapter_g=params["shared_adapters"][g])[0]
            if self.remat is not None:          # reference :236-238
                shared = self._wrap_remat(shared, "full")
            for g in range(ng):
                h = shared(h, g)
                for j in range(grp):
                    h = mamba(h, "mamba", g, j)
            for j in range(tail):
                h = mamba(h, "mamba_tail", j)
        # the norm gathers the sequence: the logits come out of the head's
        # product in their own layout (batch x vocabulary)
        with span("turnip.lm.head"):
            return unembed(_norm(cfg, params, "ln_f", h), params["unembed"])

    # -------------------------------------------------------------- loss
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of ``batch["tokens"]`` against
        ``batch["labels"]`` (both [B, S], tensors or arrays) over the true
        vocabulary, in f32; plus ``0.01·aux / n_layers`` for MoE. With
        ``batch["vision_embeds"]``, the frontend's positions take no
        loss."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        logits = self.apply(params, tokens.long(),
                            vision_embeds=batch.get("vision_embeds"))
        with span("turnip.lm.head"):
            logits = logits[:, logits.shape[1] - labels.shape[1]:].float()
            loss = token_nll(logits, labels.long(), cfg.vocab_size).mean()
        if cfg.family == "moe":
            loss = loss + 0.01 * self._aux / cfg.n_layers
        return loss

    def _mamba(self, p: dict, h: torch.Tensor, **state):
        cfg = self.cfg
        return SSM.ssd_block(p, h, d_state=cfg.ssm_state,
                             headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                             **state)

    def _zamba_groups(self, params: dict):
        """(g, the group's Mamba layers) for each group, in order."""
        ng, grp, _ = self._zamba_split()
        for g in range(ng):
            gp = layer_params(params["mamba"], g)
            yield g, [layer_params(gp, j) for j in range(grp)]

    def _zamba_tail(self, params: dict) -> list[dict]:
        tail = self._zamba_split()[2]
        return [layer_params(params["mamba_tail"], j) for j in range(tail)]

    # ------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev, dt = self.cfg, self.device, self.dtype
        f32 = torch.float32
        if cfg.family == "rwkv":
            H, P, Ln = (cfg.d_model // cfg.rwkv_headdim, cfg.rwkv_headdim,
                        cfg.n_layers)
            return {
                "tm_shift": torch.zeros((Ln, batch, 1, cfg.d_model),
                                        dtype=dt, device=dev),
                "cm_shift": torch.zeros((Ln, batch, 1, cfg.d_model),
                                        dtype=dt, device=dev),
                "wkv": torch.zeros((Ln, batch, H, P, P), dtype=f32,
                                   device=dev),
            }
        if cfg.family == "zamba":
            ng, grp, tail = self._zamba_split()
            di = cfg.ssm_expand * cfg.d_model
            H, P, N = di // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state
            convdim = di + 2 * N
            kv = (ng, batch, max_len, cfg.n_kv_heads, cfg.d_head)
            cache = {
                "ssm": torch.zeros((ng, grp, batch, H, P, N), dtype=f32,
                                   device=dev),
                "conv": torch.zeros((ng, grp, batch, 3, convdim), dtype=dt,
                                    device=dev),
                "k": torch.zeros(kv, dtype=dt, device=dev),
                "v": torch.zeros(kv, dtype=dt, device=dev),
            }
            if tail:
                cache["ssm_tail"] = torch.zeros((tail, batch, H, P, N),
                                                dtype=f32, device=dev)
                cache["conv_tail"] = torch.zeros((tail, batch, 3, convdim),
                                                 dtype=dt, device=dev)
            return cache
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
        attends.

        Attention families only (dense / moe): a recurrent family carries
        per-step state, so its prompt pass *is* the decode loop."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe"):
            raise ValueError("prefill supports attention families only "
                             f"(got {cfg.family!r})")
        B, S = tokens.shape
        K, Dh = cfg.n_kv_heads, cfg.d_head
        h = embed_rows(params["embed"], tokens)
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
            h = h + self._ffn(lp, _norm(cfg, lp, "ln2", h))[0]
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
                           sel: torch.Tensor,
                           adapter_g: torch.Tensor | None = None
                           ) -> torch.Tensor:
        """One-token attention + MLP. ``lens`` [B] is each row's cache
        length: the row writes this token at its own position. Only rows
        ``sel`` write; the others leave the cache untouched. ``layer``
        indexes the cache's leading axis (Zamba2: the group)."""
        cfg = self.cfg
        B = h.shape[0]
        x = _norm(cfg, p, "ln1", h)
        if adapter_g is not None:
            x = x * adapter_g
        pa = p["attn"]
        dims = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    d_head=cfg.d_head, rope_theta=cfg.rope_theta)
        if "k_scale" in cache:
            q, k, v = L.decode_qkv(pa, x, lens[:, None], **dims)
            kq, ksc = _quant_int8(k)
            vq, vsc = _quant_int8(v)
            at = (sel, lens[sel])

            def put(name: str, upd: torch.Tensor) -> torch.Tensor:
                return L.cache_put(cache[name][layer], upd, at)

            o = L.decode_attention_q8(q, put("k", kq), put("v", vq),
                                      put("k_scale", ksc),
                                      put("v_scale", vsc), lens + 1)
            h = h + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ pa["wo"]
        else:
            h = h + L.decode_attention_block(pa, x, cache["k"][layer],
                                             cache["v"][layer], lens, sel,
                                             **dims)
        return h + self._ffn(p, _norm(cfg, p, "ln2", h))[0]

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    cache_len, active: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode. token: [B, 1] → logits [B, padded_vocab].

        ``cache_len`` is an int (all rows at the same depth) or per-row [B]
        (a ragged continuous-batching step). ``active`` is an optional [B]
        bool mask: rows that are False write nothing into the cache; their
        logits are garbage and the caller must ignore them. The cache is
        updated in place, at each active row's own position, and returned.
        The mask is only supported for the attention families: recurrent
        state (rwkv / zamba SSM) advances unconditionally, and an ``active``
        mask raises for them."""
        cfg = self.cfg
        if active is not None and cfg.family not in ("dense", "moe"):
            raise ValueError(
                "active-row masking requires a KV-cache family (dense/moe)")
        if active is not None and meshed(token):
            raise ValueError("under a mesh every row of a decode step "
                             "writes its cache: no active-row mask")
        B = token.shape[0]
        dev = self.device
        lens = torch.as_tensor(cache_len, dtype=torch.int64,
                               device=dev).reshape(-1).expand(B)
        sel = (torch.arange(B, device=dev) if active is None
               else torch.nonzero(torch.as_tensor(active, device=dev)
                                  ).flatten())
        h = embed_rows(params["embed"], token)              # [B, 1, D]
        if cfg.family in ("dense", "moe"):
            for i in range(cfg.n_layers):
                h = self._attn_decode_block(layer_params(params["layers"], i),
                                            h, cache, i, lens, sel)
        elif cfg.family == "rwkv":
            for i in range(cfg.n_layers):
                lp = layer_params(params["layers"], i)
                o, (tms, wkv) = R.rwkv6_time_mix(
                    lp, _norm(cfg, lp, "ln1", h), headdim=cfg.rwkv_headdim,
                    state=(cache["tm_shift"][i], cache["wkv"][i]))
                h = h + o
                o, cms = R.rwkv6_channel_mix(
                    lp, _norm(cfg, lp, "ln2", h), state=cache["cm_shift"][i])
                h = h + o
                cache["tm_shift"][i].copy_(tms)
                cache["cm_shift"][i].copy_(cms)
                cache["wkv"][i].copy_(wkv)
        else:                                             # zamba
            def mamba_step(lp, h, ssm, conv):
                o, (st, cs) = self._mamba(lp, h, state=ssm, conv_state=conv)
                ssm.copy_(st)
                conv.copy_(cs)
                return h + o

            for g, lps in self._zamba_groups(params):
                h = self._attn_decode_block(
                    params["shared"], h, cache, g, lens, sel,
                    adapter_g=params["shared_adapters"][g])
                for j, lp in enumerate(lps):
                    h = mamba_step(lp, h, cache["ssm"][g, j],
                                   cache["conv"][g, j])
            for j, lp in enumerate(self._zamba_tail(params)):
                h = mamba_step(lp, h, cache["ssm_tail"][j],
                               cache["conv_tail"][j])
        h = _norm(cfg, params, "ln_f", h)
        return (h @ params["unembed"])[:, 0], cache
