"""The plain float32 reference of the port's ``rwkv`` family (RWKV-6
"Finch"), and the benchmark's weights for it in the program's parameter
layout.

The same function as ``repro_torch/models/lm.py``'s rwkv path and
``models/rwkv.py``, written again from the equations: per layer
``h += time_mix(layernorm(h))`` and ``h += channel_mix(layernorm(h))``.
Time mix: token shift, the five data-dependent mixes (a shared tanh LoRA),
r, k, v, the SiLU gate g, the decay ``lw = -exp(w_base + tanh(x_w A_w)
B_w)``, the WKV recurrence (``wkv``) with its bonus ``u``, an rmsnorm over
all channels times g, the out-projection. Channel mix: token shift,
``sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)``. Float32, TF32 off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Lin, layernorm, lora_weight, rmsnorm

__all__ = ["weight_specs", "Reference", "wkv"]



def weight_specs(config: dict) -> list[tuple]:
    """The program's rwkv parameter tree as ``make_weights`` specs, for a
    configuration file: ``as_run``'s sizes, and the token-shift and decay
    LoRAs at the file's ``time_mix_extra_dim`` and
    ``time_decay_extra_dim``; the mixes U(0, 1) and the LoRA B factors
    N(0, 0.01^2), so that the data-dependent paths do work, and RWKV-6's
    own decay and bonus initialisation (:func:`finish_weights`)."""
    arch = config["as_run"]
    bf = getattr(torch, arch["dtype"])
    f32 = torch.float32
    D, Fd, L = arch["d_model"], arch["d_ff"], arch["n_layers"]
    Vp = -(-arch["vocab_size"] // 128) * 128
    P = arch["rwkv_headdim"]
    H = D // P
    r, rw = config["time_mix_extra_dim"], config["time_decay_extra_dim"]
    s = 1 / math.sqrt(D)
    lead = (L,)
    return [
        ("embed", (Vp, D), bf, "normal", 0.02),
        ("unembed", (D, Vp), bf, "normal", s),
        ("ln_f_g", (D,), bf, "ones", None),
        ("ln_f_b", (D,), bf, "zeros", None),
        ("layers/mix_rkvwg", lead + (5, D), bf, "uniform", None),
        ("layers/mix_lora_A", lead + (D, 5 * r), bf, "normal", s),
        ("layers/mix_lora_B", lead + (5, r, D), bf, "normal", 0.01),
        ("layers/w_lora_A", lead + (D, rw), bf, "normal", s),
        ("layers/w_lora_B", lead + (rw, D), bf, "normal", 0.01),
        ("layers/w_base", lead + (D,), f32, "zeros", None),
        ("layers/wr", lead + (D, D), bf, "normal", s),
        ("layers/wk", lead + (D, D), bf, "normal", s),
        ("layers/wv", lead + (D, D), bf, "normal", s),
        ("layers/wg", lead + (D, D), bf, "normal", s),
        ("layers/bonus_u", lead + (H, P), f32, "zeros", None),
        ("layers/ln_x_g", lead + (D,), bf, "ones", None),
        ("layers/wo", lead + (D, D), bf, "normal", s),
        ("layers/cmix_k", lead + (D,), bf, "uniform", None),
        ("layers/cmix_r", lead + (D,), bf, "uniform", None),
        ("layers/ck", lead + (D, Fd), bf, "normal", s),
        ("layers/cv", lead + (Fd, D), bf, "normal", 1 / math.sqrt(Fd)),
        ("layers/cr", lead + (D, D), bf, "normal", s),
        ("layers/ln1_g", lead + (D,), bf, "ones", None),
        ("layers/ln1_b", lead + (D,), bf, "zeros", None),
        ("layers/ln2_g", lead + (D,), bf, "ones", None),
        ("layers/ln2_b", lead + (D,), bf, "zeros", None)]


def finish_weights(params: dict, src: dict) -> None:
    """RWKV-6's decay and bonus initialisation, in place: for layer l of L
    and channel i of D, ``w_base = -6 + 5 (i/(D-1))^(0.7 + 1.3 l/(L-1))``
    and ``bonus_u = (l/(L-1)) (1 - i/(D-1)) + 0.1 ((i+1) mod 3 - 1)``."""
    p = params["layers"]
    L, D = p["w_base"].shape
    dev = p["w_base"].device
    ratio = (torch.arange(L, dtype=torch.float32, device=dev)
             / max(L - 1, 1))[:, None]
    i = torch.arange(D, dtype=torch.float32, device=dev)[None, :]
    frac = i / max(D - 1, 1)
    p["w_base"].copy_(-6 + 5 * frac ** (0.7 + 1.3 * ratio))
    zig = ((i.long() + 1) % 3 - 1).float() * 0.1
    p["bonus_u"].copy_((ratio * (1 - frac) + zig).view(p["bonus_u"].shape))


def wkv(r, k, v, lw, u, chunk: int = 32) -> torch.Tensor:
    """y_t = sum_{s < t} r_t (prod_{s < q < t} w_q) k_s^T v_s
    + (r_t u k_t) v_t per head, w = exp(lw), from a zero state.
    r/k/v/lw [B, S, H, P] float32, u [H, P]. Within a chunk the pairs'
    decays factor through the chunk's start (exp of at most chunk x
    max|lw|); the state entering each chunk is carried chunk by chunk."""
    B, S, H, P = r.shape
    pad = -S % chunk
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    c = (S + pad) // chunk
    r, k, v, lw = (t.reshape(B, c, chunk, H, P) for t in (r, k, v, lw))
    cum = torch.cumsum(lw, dim=2)                      # inclusive, <= 0
    prev = cum - lw                                    # exclusive
    last = cum[:, :, -1:]
    rq = r * torch.exp(prev)
    kq = k * torch.exp(-cum)
    strict = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    A = torch.einsum("bcthp,bcshp->bchts", rq, kq) * strict
    y = torch.einsum("bchts,bcshp->bcthp", A, v)
    y = y + (r * u * k).sum(-1, keepdim=True) * v
    U = torch.einsum("bcshp,bcshq->bchpq", k * torch.exp(last - cum), v)
    dec = torch.exp(last[:, :, 0])                     # b c h p
    s = torch.zeros(B, H, P, P, dtype=r.dtype, device=r.device)
    entering = []
    for j in range(c):
        entering.append(s)
        s = dec[:, j][..., None] * s + U[:, j]
    y = y + torch.einsum("bcthp,bchpq->bcthq", rq, torch.stack(entering, 1))
    return y.reshape(B, c * chunk, H, P)[:, :S]


def _shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


class Reference:
    """The rwkv model on the benchmark's weights ``params`` (the program's
    layout), in float32, its products by ``Lin(precision)``."""

    def __init__(self, arch: dict, params: dict, *, precision: str = "fp32",
                 lora_scale: float = 1.0) -> None:
        self.arch, self.p = arch, params
        self.lin = Lin(precision)
        self.scale = lora_scale
        self.vocab = arch["vocab_size"]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"][tokens.long()].float()

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.lin(layernorm(h, self.p["ln_f_g"], self.p["ln_f_b"]),
                        self.p["unembed"])

    def layers(self, ad: dict | None = None) -> list:
        ad = ad or {}
        return [lambda h, i=i: self._layer(h, i, ad)
                for i in range(self.arch["n_layers"])]

    def _layer(self, h, i, ad):
        p = {k: v[i] for k, v in self.p["layers"].items()}
        h = h + self._time_mix(layernorm(h, p["ln1_g"], p["ln1_b"]), p, i, ad)
        return h + self._channel_mix(layernorm(h, p["ln2_g"], p["ln2_b"]), p)

    def _time_mix(self, x, p, i, ad):
        B, S, D = x.shape
        P = self.arch["rwkv_headdim"]
        H = D // P
        lin = self.lin
        dx = _shift(x) - x
        lr = torch.tanh(lin(x, p["mix_lora_A"])).view(B, S, 5, -1)
        mixes = p["mix_rkvwg"].float() + torch.einsum(
            "bsfr,frd->bsfd", lr, p["mix_lora_B"].float())
        xr, xk, xv, xw, xg = (x + dx * mixes[:, :, j] for j in range(5))

        def w(name):
            path = f"layers/{name}"
            return lora_weight(self.p["layers"][name], ad.get(path),
                               self.scale, index=i)
        r = lin(xr, w("wr")).view(B, S, H, P)
        k = lin(xk, w("wk")).view(B, S, H, P)
        v = lin(xv, w("wv")).view(B, S, H, P)
        g = F.silu(lin(xg, w("wg")))
        lw = p["w_base"].float() + lin(torch.tanh(lin(xw, p["w_lora_A"])),
                                       p["w_lora_B"])
        lw = -torch.exp(lw).view(B, S, H, P)
        y = wkv(r, k, v, lw, p["bonus_u"].float()).reshape(B, S, D)
        return lin(rmsnorm(y, p["ln_x_g"]) * g, p["wo"])

    def _channel_mix(self, x, p):
        dx = _shift(x) - x
        xk = x + dx * p["cmix_k"].float()
        xr = x + dx * p["cmix_r"].float()
        k = torch.square(torch.relu(self.lin(xk, p["ck"])))
        return torch.sigmoid(self.lin(xr, p["cr"])) * self.lin(k, p["cv"])
