"""Mamba2 / SSD blocks (for zamba2-7b): the port of ``repro/models/ssm.py``.

The same structure: in-projection, a short depthwise causal convolution,
the SSD scan with a scalar decay per head, Δ per token and B, C of state
size N, then the gated rmsnorm and the out-projection. The sequence
forward's scan goes to the Hopper kernel on CUDA
(:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`); the decode step,
which carries a state, runs :func:`_ssd_chunked`, the model's own
recurrence in plain torch (no TPU kernel takes or returns a state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels.ssd_scan.ops import ssd_scan
from . import layers as L

__all__ = ["ssd_init", "ssd_block"]


def ssd_init(gen: torch.Generator, d_model: int, *, d_state: int = 64,
             headdim: int = 64, expand: int = 2, d_conv: int = 4,
             dtype=torch.float32, leading: tuple[int, ...] = (),
             device=None) -> dict:
    """The reference's leaves, distributions and scales, ``leading`` dims
    first (``(ng, grp)`` stacks zamba's groups of layers); ``A_log``, ``D``
    and ``dt_bias`` in f32 whatever ``dtype``."""
    dev = resolve_device(device)
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    convdim = d_inner + 2 * d_state
    s = 1.0 / math.sqrt(d_model)
    A_log = torch.log(torch.linspace(1.0, 16.0, n_heads,
                                     dtype=torch.float32, device=dev))
    return {
        # projections: [z (gate), x, B, C, dt]
        "in_proj": L.randn(gen, leading + (d_model, 2 * d_inner + 2 * d_state
                                           + n_heads), dtype, s, dev),
        "conv_w": L.randn(gen, leading + (d_conv, convdim), dtype, 0.1, dev),
        "conv_b": torch.zeros(leading + (convdim,), dtype=dtype, device=dev),
        "A_log": A_log.expand(leading + (n_heads,)).contiguous(),
        "D": torch.ones(leading + (n_heads,), dtype=torch.float32,
                        device=dev),
        "dt_bias": torch.zeros(leading + (n_heads,), dtype=torch.float32,
                               device=dev),
        "norm_g": torch.ones(leading + (d_inner,), dtype=dtype, device=dev),
        "out_proj": L.randn(gen, leading + (d_inner, d_model), dtype,
                            1.0 / math.sqrt(d_inner), dev),
    }


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in f32 plain torch, the reference's recurrence.

    xh: [B, S, H, P]; dt: [B, S, H] (softplus'ed); A: [H] (negative);
    Bm/Cm: [B, S, N]; ``h0`` [B, H, P, N] the incoming state (zeros when
    None). Returns (y [B, S, H, P], final state [B, H, P, N])."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    nch = max(1, (S + chunk - 1) // chunk)
    pad = nch * chunk - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xc = xh.reshape(Bsz, nch, chunk, H, Pd)
    dtc = dt.reshape(Bsz, nch, chunk, H)
    Bc = Bm.reshape(Bsz, nch, chunk, N)
    Cc = Cm.reshape(Bsz, nch, chunk, N)
    dA = dtc * A                                      # [B,c,l,H] (negative)
    seg = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=xh.device))
    h = (torch.zeros(Bsz, H, Pd, N, dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    ys = []
    for j in range(nch):
        xj, dtj, Bj, Cj = xc[:, j], dtc[:, j], Bc[:, j], Cc[:, j]
        segj = seg[:, j]
        # mask the exponent's input: s > t differences are positive
        diff = segj[:, :, None, :] - segj[:, None, :, :]      # [B,t,s,H]
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None], -1e30))
        cb = torch.einsum("btn,bsn->bts", Cj, Bj)
        w = cb[..., None] * decay * dtj[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", w, xj)
        y_state = torch.einsum("btn,bhpn,bth->bthp", Cj, h, torch.exp(segj))
        tail = torch.exp(segj[:, -1:, :] - segj)              # [B,l,H]
        upd = torch.einsum("bsh,bsn,bshp->bhpn", tail * dtj, Bj, xj)
        h = h * torch.exp(dA[:, j].sum(dim=1))[:, :, None, None] + upd
        ys.append(y_intra + y_state)
    y = torch.stack(ys, dim=1).reshape(Bsz, nch * chunk, H, Pd)[:, :S]
    return y, h


def ssd_block(p: dict, x: torch.Tensor, *, d_state: int = 64,
              headdim: int = 64, expand: int = 2, chunk: int = 128,
              state: torch.Tensor | None = None,
              conv_state: torch.Tensor | None = None,
              return_state: bool = False):
    """Full Mamba2 mixer. x: [B, S, D]. In decode mode pass ``state``
    ([B, H, P, N]) and ``conv_state`` ([B, d_conv - 1, convdim]) and S may
    be 1; it then returns ``(out, (new state, new conv state))``.

    The reference's dtype order, step for step: the depthwise causal
    convolution as ``d_conv`` shifted multiply-adds in x.dtype (not
    ``F.conv1d``, which accumulates in f32), ``softplus(dt.float() +
    dt_bias)``, the scan in f32, ``+ xh·D`` in f32, the cast to x.dtype,
    then ``rmsnorm(y · silu(z), norm_g)`` through the rmsnorm kernel.
    Without a state the scan is the ``ssd_scan`` kernel
    (``chunk=min(chunk, S)``). With one, or with ``return_state``, it is
    :func:`_ssd_chunked` from ``state`` (zeros when None): no TPU kernel
    takes a state or returns one, so this recurrence stays plain torch, as
    the one-token decode attention does."""
    Bsz, S, D = x.shape
    d_inner = expand * D
    H = d_inner // headdim
    N = d_state
    proj = x @ p["in_proj"]
    z, xr, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, N, N, H],
                                    dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)          # [B, S, convdim]
    dconv = p["conv_w"].shape[0]
    if conv_state is not None:
        conv_in_full = torch.cat([conv_state, conv_in], dim=1)
        new_conv_state = conv_in_full[:, -(dconv - 1):]
    else:
        conv_in_full = F.pad(conv_in, (0, 0, dconv - 1, 0))
        new_conv_state = (conv_in_full[:, -(dconv - 1):] if return_state
                          else None)
    conv = torch.zeros_like(conv_in)
    for j in range(dconv):
        conv = conv + conv_in_full[:, j:j + S] * p["conv_w"][j]
    conv = F.silu(conv + p["conv_b"])
    xr, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)

    A = -torch.exp(p["A_log"])                          # [H]
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xr.reshape(Bsz, S, H, headdim).float()
    Bf, Cf = Bm.float().contiguous(), Cm.float().contiguous()
    c = min(chunk, max(S, 1))
    if state is None and not return_state:
        L.no_backward("ssd_scan", xh, dt, A, Bf, Cf)
        y = ssd_scan(xh.contiguous(), dt, A, Bf, Cf, chunk=c)
    else:
        y, hT = _ssd_chunked(xh, dt, A, Bf, Cf, chunk=c, h0=state)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm_g"])
    out = y @ p["out_proj"]
    if return_state or state is not None:
        return out, (hT, new_conv_state)
    return out
