"""RWKV-6 "Finch" blocks (for rwkv6-7b): the port of
``repro/models/rwkv.py``.

Time-mix: token-shift interpolation with a data-dependent mix (a small
LoRA), a per-channel data-dependent decay ``w_t`` and the WKV linear
attention over a per-head state ``S [P, P]``:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t        y_t = r_t S_t + bonus u

Channel-mix: a squared-ReLU gated MLP with token shift. The sequence
forward's WKV goes to the Hopper kernel on CUDA
(:func:`repro_torch.kernels.rwkv6.ops.wkv6`); the decode step, which
carries a state, runs :func:`wkv6_chunked`, the model's own recurrence in
plain torch (no TPU kernel takes or returns a state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.rwkv6.ops import wkv6
from ..sharding.rules import constrain, meshed, split_last
from ..spans import span, spanned
from . import layers as L

__all__ = ["rwkv6_init", "wkv6_chunked", "rwkv6_time_mix",
           "rwkv6_channel_mix"]


def rwkv6_init(gen: torch.Generator, d_model: int, *, headdim: int = 64,
               lora_r: int = 32, d_ff: int | None = None,
               dtype=torch.float32, leading: tuple[int, ...] = (),
               device=None) -> dict:
    """The reference's leaves, distributions and scales, ``leading`` dims
    first (``(L,)`` stacks a model's layers): the static mixes, the LoRAs'
    B factors, ``bonus_u`` and the channel-mix coefficients start at zero;
    ``w_base`` (-6) and ``bonus_u`` are f32 whatever ``dtype``."""
    dev = resolve_device(device)
    H = d_model // headdim
    d_ff = d_ff or int(3.5 * d_model)
    s = 1.0 / math.sqrt(d_model)

    def zeros(*shape, dt=dtype):
        return torch.zeros(leading + shape, dtype=dt, device=dev)

    def normal(shape, scale):
        return L.randn(gen, leading + shape, dtype, scale, dev)

    D = d_model
    return {
        # time-mix
        "mix_rkvwg": zeros(5, D),                       # static mix coeffs
        "mix_lora_A": normal((D, 5 * lora_r), s),
        "mix_lora_B": zeros(5, lora_r, D),
        "w_lora_A": normal((D, lora_r), s),
        "w_lora_B": zeros(lora_r, D),
        "w_base": torch.full(leading + (D,), -6.0, dtype=torch.float32,
                             device=dev),               # decay base
        "wr": normal((D, D), s),
        "wk": normal((D, D), s),
        "wv": normal((D, D), s),
        "wg": normal((D, D), s),
        "bonus_u": zeros(H, headdim, dt=torch.float32),
        "ln_x_g": torch.ones(leading + (D,), dtype=dtype, device=dev),
        "wo": normal((D, D), s),
        # channel-mix
        "cmix_k": zeros(D),
        "cmix_r": zeros(D),
        "ck": normal((D, d_ff), s),
        "cv": normal((d_ff, D), 1.0 / math.sqrt(d_ff)),
        "cr": normal((D, D), s),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x[t-1] (zeros, or the carried ``prev`` [B, 1, D], at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lw: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
                 s0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 recurrence in plain torch, the reference's own.

    r/k/v: [B, S, H, P] f32; ``lw`` the log decay (<= 0); u: [H, P]; ``s0``
    [B, H, P, P] the incoming state (zeros when None). Within a chunk every
    decay factor is exp of a difference of cumulative log-decays, <= 0.
    Returns (y [B, S, H, P], final state [B, H, P, P])."""
    B, S, H, Pd = r.shape
    c = min(chunk, S)
    n = (S + c - 1) // c
    pad = n * c - S
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                        diagonal=-1)
    S_in = (torch.zeros(B, H, Pd, Pd, dtype=torch.float32, device=r.device)
            if s0 is None else s0)
    ys = []
    for j in range(n):
        sl = slice(j * c, (j + 1) * c)
        rj, kj, vj, lwj = r[:, sl], k[:, sl], v[:, sl], lw[:, sl]
        lcw = torch.cumsum(lwj, dim=1)                # inclusive cumsum
        prev = lcw - lwj                              # lcw_{t-1}
        # intra-chunk: A[t,s] = sum_p r_t k_s e^{prev_t - lcw_s}, s < t;
        # mask the exponent's input (s >= t differences are positive)
        diff = prev[:, :, None] - lcw[:, None]        # [B,t,s,H,P]
        E = torch.exp(diff.masked_fill(~strict[None, :, :, None, None],
                                       -1e30))
        A = torch.einsum("bthp,btshp,bshp->bths", rj, E, kj)
        y = torch.einsum("bths,bshq->bthq", A, vj)
        du = torch.einsum("bthp,hp,bthp->bth", rj, u, kj)   # bonus
        y = y + du[..., None] * vj
        y = y + torch.einsum("bthp,bhpq->bthq", rj * torch.exp(prev), S_in)
        tailw = torch.exp(lcw[:, -1:] - lcw)          # [B,c,H,P] <= 1
        S_in = (torch.exp(lcw[:, -1])[..., None] * S_in
                + torch.einsum("bshp,bshq->bhpq", kj * tailw, vj))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, S_in


@spanned("turnip.rwkv.time_mix")
def rwkv6_time_mix(p: dict, x: torch.Tensor, *, headdim: int = 64,
                   chunk: int = 32, state: tuple | None = None,
                   return_state: bool = False):
    """x: [B, S, D]. ``state``: (shift [B, 1, D], wkv [B, H, P, P]); with
    it (or ``return_state``) returns ``(out, (x[:, -1:], new wkv))``.

    The reference's dtype order: the mixes and projections in x.dtype,
    ``lw = w_base + (tanh(xw @ w_lora_A) @ w_lora_B).float()`` then
    ``-exp(lw)``, r, k, v cast to f32 for the recurrence, y cast back, then
    ``rmsnorm(y, ln_x_g) * g`` through the rmsnorm kernel. Without a state
    the recurrence is the ``wkv6`` kernel; with one it is
    :func:`wkv6_chunked` from the state, which no TPU kernel computes."""
    B, S, D = x.shape
    H = D // headdim
    Pd = headdim
    prev = state[0] if state is not None else None
    with span("turnip.rwkv.mix"):
        xs = _token_shift(x, prev)
        dx = xs - x
        # data-dependent mixing coefficients (5 heads of a shared LoRA)
        lr = split_last(torch.tanh(x @ p["mix_lora_A"]), B, S, 5, -1)
        mixes = p["mix_rkvwg"][None, None] + torch.einsum(
            "bsfr,frd->bsfd", lr, p["mix_lora_B"])    # [B, S, 5, D]
        xr, xk, xv, xw, xg = (x + dx * mixes[:, :, i] for i in range(5))

    r = split_last(xr @ p["wr"], B, S, H, Pd)
    k = split_last(xk @ p["wk"], B, S, H, Pd)
    v = split_last(xv @ p["wv"], B, S, H, Pd)
    g = F.silu(xg @ p["wg"])
    lw = torch.tanh(xw @ p["w_lora_A"]) @ p["w_lora_B"]
    with span("turnip.rwkv.wkv"):
        r = r.float()
        k = k.float()
        v = v.float()
        # data-dependent decay w in (0, 1): log w = -exp(...) (<= 0 always)
        lw = split_last(-torch.exp(p["w_base"] + lw.float()), B, S, H, Pd)
        if state is None and not return_state:
            if meshed(r):
                from ..sharding.local import wkv6 as meshed_wkv6
                y = meshed_wkv6(wkv6, r, k, v, lw, p["bonus_u"], chunk)
            else:
                y = wkv6(r, k, v, lw, p["bonus_u"], chunk=chunk)
        elif state is not None and meshed(r):
            from ..sharding.local import wkv6 as meshed_wkv6
            y, sT = meshed_wkv6(wkv6_chunked, r, k, v, lw, p["bonus_u"],
                                chunk, state=state[1])
        else:
            y, sT = wkv6_chunked(r, k, v, lw, p["bonus_u"], chunk=chunk,
                                 s0=state[1] if state is not None else None)
        y = y.reshape(B, S, D).to(x.dtype)
    y = L.rmsnorm(y, p["ln_x_g"]) * g    # GroupNorm ~ per-head rmsnorm
    # placed by batch before the residual add (``layers._batch_sharded``)
    out = constrain(y @ p["wo"], ("pod", "data"), None, None)
    if return_state or state is not None:
        return out, (x[:, -1:], sT)
    return out


@spanned("turnip.rwkv.channel_mix")
def rwkv6_channel_mix(p: dict, x: torch.Tensor, *,
                      state: torch.Tensor | None = None,
                      return_state: bool = False):
    """x: [B, S, D]; ``state`` the shift [B, 1, D]; with it (or
    ``return_state``) returns ``(out, x[:, -1:])``."""
    with span("turnip.rwkv.mix"):
        xs = _token_shift(x, state)
        dx = xs - x
        xk = x + dx * p["cmix_k"]
        xr = x + dx * p["cmix_r"]
    k = torch.square(torch.relu(xk @ p["ck"]))
    kv = k @ p["cv"]
    out = constrain(torch.sigmoid(xr @ p["cr"]) * kv, ("pod", "data"), None,
                    None)
    if return_state or state is not None:
        return out, x[:, -1:]
    return out
