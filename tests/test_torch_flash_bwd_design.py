"""The Hopper flash-attention backward's design, emulated in torch on the
CPU (``csrc/flash_attention_bwd.cu`` runs only on the card).

The emulation follows the kernel's two launches tile by tile: (a) a block
of 128 query rows, two warpgroups of 64, over 64-row KV tiles up to each
warpgroup's causal edge, Di = rowsum(dO o O) per row, dQ summed in f32 in
KV-tile order; (b) a block of 128 KV rows, two warpgroups of 64, over the
G query heads of the group and the 64-row query tiles from the first one
the causal mask leaves (``q_offset`` shifts it), skipping a warpgroup's
tiles wholly before its causal edge, dK and dV summed in f32 in (head,
query tile) order. P = 2^(S scale log2(e) - lse log2(e)) is masked as the
kernel masks it, and the P and dS operands of the products are rounded as
the kernel issues them: bfloat16 hi + lo (two products into one f32 sum),
float16 once, float32 as they are.

Checked against ``flash_attention_bwd_plain`` and ``jax.grad`` of the
reference's attention (``repro/kernels/flash_attention/ref.py``) on shapes
with GQA 1, 2 and 4, Sq != Skv, q_offset > 0 and head size 112:
- float32 (no rounding): rtol 1e-4, atol 1e-5 against both (sums over up
  to 256 keys in other orders);
- bfloat16 and float16 inputs: within ``gradient_limit`` of the plain
  version, the rule the card holds the kernel to;
- tile skipping: the emulation that skips tiles gives the same bytes as one
  that computes every tile with the mask, since a masked P is an exact 0;
- the bf16 split is needed: with P and dS rounded once to bfloat16 the
  gradients leave ``gradient_limit`` on a 2048-key causal row set.
The variants that ``bwd_variants`` times on the card still apply to the
source.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention.bwd_variants import (
    VARIANTS, variant_source)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd_plain, flash_attention_plain, gradient_limit,
    lse_plain)

torch.set_num_threads(1)

DQ_BQ, KV_BK, TILE = 128, 128, 64       # the kernel's block and tile rows
LOG2E = 1.4426950408889634

# (B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset)
CASES = [(2, 128, 128, 4, 4, 64, True, 0),       # GQA 1
         (1, 200, 200, 4, 2, 128, True, 0),      # GQA 2, ragged tiles
         (1, 96, 160, 8, 2, 64, False, 0),       # GQA 4, Sq != Skv
         (1, 64, 256, 4, 1, 32, True, 192),      # q_offset, MQA
         (1, 100, 130, 4, 4, 112, True, 30),     # head size 112
         (2, 70, 40, 4, 2, 112, True, 0)]        # keys no query sees
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _draw(case, seed, dtype=torch.float32):
    B, Sq, Skv, Hq, Hkv, Dh, _, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh),
             (B, Sq, Hq, Dh))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _operand(x, dtype, split=True):
    """A P or dS tile as the kernel issues it, as the list of the rounded
    parts it multiplies: bfloat16 hi + lo (once without ``split``), float16
    once, float32 as is."""
    if dtype == torch.bfloat16:
        hi = x.to(dtype).float()
        return [hi, (x - hi).to(dtype).float()] if split else [hi]
    if dtype == torch.float16:
        return [x.to(dtype).float()]
    return [x]


def _rows(x, start, n):
    """Rows [start, start + n) of x's dim 1, zeros past its end (TMA's
    fill)."""
    out = x.new_zeros((x.shape[0], n) + x.shape[2:])
    got = x[:, start:start + n]
    out[:, :got.shape[1]] = got
    return out


def _visible(q_pos, kv_pos, Sq, Skv, causal, q_offset):
    """[len(q_pos), len(kv_pos)] bool, the kernel's ``visible``."""
    m = (q_pos[:, None] < Sq) & (kv_pos[None, :] < Skv)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None] + q_offset
    return m


def emulate_bwd(q, k, v, o, do, lse, *, causal=True, q_offset=0,
                skip=True, split=True):
    """(dq, dk, dv) as the card's two launches compute them (module
    docstring). ``skip=False`` computes every tile under the mask instead
    of skipping those the mask leaves empty; ``split=False`` rounds the
    bfloat16 operands once."""
    dt = q.dtype
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    c = scale * LOG2E
    # [B, H, S, Dh] f32 views; a query head's KV head is h // G
    qf, of, dof = (t.float().permute(0, 2, 1, 3) for t in (q, o, do))
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    kq, vq = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    lse2 = lse.float() * LOG2E                          # [B, Hq, Sq]
    di = (dof * of).sum(-1)                             # [B, Hq, Sq]

    # (a) dQ: blocks of 128 query rows, warpgroups of 64
    dq = torch.zeros(B, Hq, Sq, Dh)
    for q0 in range(0, Sq, DQ_BQ):
        kv_end = Skv
        if causal:
            kv_end = min(Skv, min(Sq, q0 + DQ_BQ) + q_offset)
        n_kt = -(-kv_end // TILE)
        for lo in (q0, q0 + 64):
            if lo >= Sq:
                continue
            n_live = n_kt
            if causal and skip:
                n_live = min(n_kt, (lo + 63 + q_offset) // TILE + 1)
            q_pos = torch.arange(lo, lo + 64)
            qw = _rows(qf.transpose(1, 2), lo, 64).transpose(1, 2)
            dow = _rows(dof.transpose(1, 2), lo, 64).transpose(1, 2)
            l2 = _rows(lse2.transpose(1, 2), lo, 64).transpose(1, 2)
            dw = _rows(di.transpose(1, 2), lo, 64).transpose(1, 2)
            acc = torch.zeros(B, Hq, 64, Dh)
            for t in range(n_live):
                k0 = t * TILE
                kt = _rows(kq.transpose(1, 2), k0, TILE).transpose(1, 2)
                vt = _rows(vq.transpose(1, 2), k0, TILE).transpose(1, 2)
                mask = _visible(q_pos, torch.arange(k0, k0 + TILE), Sq, Skv,
                                causal, q_offset)
                p = torch.exp2(qw @ kt.transpose(-1, -2) * c - l2[..., None])
                p = p.masked_fill(~mask, 0.0)
                ds = p * (dow @ vt.transpose(-1, -2) - dw[..., None])
                for part in _operand(ds, dt, split):
                    acc = acc + part @ kt
            n = min(64, Sq - lo)
            dq[:, :, lo:lo + n] = acc[:, :, :n] * scale

    # (b) dK, dV: blocks of 128 KV rows, warpgroups of 64; heads of a group
    # slowest, then query tiles
    dk = torch.zeros(B, Hkv, Skv, Dh)
    dv = torch.zeros(B, Hkv, Skv, Dh)
    qg, dog = (t.reshape(B, Hkv, G, Sq, Dh) for t in (qf, dof))
    lg, dg = (t.reshape(B, Hkv, G, Sq) for t in (lse2, di))
    for kv0 in range(0, Skv, KV_BK):
        q_start = 0
        if causal:
            q_start = max(0, kv0 - q_offset) // TILE * TILE
        for lo in (kv0, kv0 + 64):
            if lo >= Skv:
                continue
            kv_pos = torch.arange(lo, lo + 64)
            kw = _rows(kf.transpose(1, 2), lo, 64).transpose(1, 2)
            vw = _rows(vf.transpose(1, 2), lo, 64).transpose(1, 2)
            acc_k = torch.zeros(B, Hkv, 64, Dh)
            acc_v = torch.zeros(B, Hkv, 64, Dh)
            for hh in range(G):
                for q0 in range(q_start, Sq, TILE):
                    if causal and skip and lo > q0 + TILE - 1 + q_offset:
                        continue
                    qt = _rows(qg[:, :, hh].transpose(1, 2), q0,
                               TILE).transpose(1, 2)
                    dot = _rows(dog[:, :, hh].transpose(1, 2), q0,
                                TILE).transpose(1, 2)
                    l2 = _rows(lg[:, :, hh].transpose(1, 2), q0,
                               TILE).transpose(1, 2)
                    dw = _rows(dg[:, :, hh].transpose(1, 2), q0,
                               TILE).transpose(1, 2)
                    mask = _visible(torch.arange(q0, q0 + TILE), kv_pos, Sq,
                                    Skv, causal, q_offset).T
                    pt = torch.exp2(kw @ qt.transpose(-1, -2) * c
                                    - l2[..., None, :])
                    pt = pt.masked_fill(~mask, 0.0)
                    dst = pt * (vw @ dot.transpose(-1, -2) - dw[..., None, :])
                    for part in _operand(pt, dt, split):
                        acc_v = acc_v + part @ dot
                    for part in _operand(dst, dt, split):
                        acc_k = acc_k + part @ qt
            n = min(64, Skv - lo)
            dk[:, :, lo:lo + n] = acc_k[:, :, :n] * scale
            dv[:, :, lo:lo + n] = acc_v[:, :, :n]
    back = lambda t: t.permute(0, 2, 1, 3).to(dt)   # noqa: E731
    return back(dq), back(dk), back(dv)


def _forward(q, k, v, causal, off):
    o = flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    return o, lse_plain(q, k, causal, off)


def _jax_grad(arrs, causal, off):
    q, k, v, do = arrs
    t = lambda a: a.transpose(0, 2, 1, 3)   # noqa: E731

    def f(qq, kk, vv):
        o = t(attention_ref(t(qq), t(kk), t(vv), causal=causal,
                            q_offset=off))
        return jnp.sum(o * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_matches_plain_and_jax_grad_f32(case):
    causal, off = case[6], case[7]
    arrs, (q, k, v, do) = _draw(case, 0)
    o, lse = _forward(q, k, v, causal, off)
    got = emulate_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    plain = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                      q_offset=off)
    for g, p, j in zip(got, plain, _jax_grad(arrs, causal, off)):
        torch.testing.assert_close(g, p, **F32_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **F32_TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_emulation_16bit_within_gradient_limit(case, dtype):
    causal, off = case[6], case[7]
    _, (q, k, v, do) = _draw(case, 1, dtype)
    o, lse = _forward(q, k, v, causal, off)
    got = emulate_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                     q_offset=off)
    name = str(dtype).removeprefix("torch.")
    for g, w in zip(got, want):
        assert g.dtype == dtype
        ratio = ((g.float() - w.float()).abs()
                 / gradient_limit(w, name)).max().item()
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]], ids=str)
def test_causal_tile_skipping_is_exact(case):
    """Skipped tiles would contribute P = 0 exactly: the same bytes."""
    causal, off = case[6], case[7]
    _, (q, k, v, do) = _draw(case, 2, torch.bfloat16)
    o, lse = _forward(q, k, v, causal, off)
    a = emulate_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
    b = emulate_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off,
                    skip=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_keys_no_query_sees_get_zero_gradients():
    """A causal KV block past every query + q_offset has no query tile in
    launch (b): its dK and dV are written as zeros, as the plain version's
    are."""
    case = (1, 64, 300, 2, 1, 64, True, 100)
    _, (q, k, v, do) = _draw(case, 3, torch.bfloat16)
    o, lse = _forward(q, k, v, True, 100)
    _, dk, dv = emulate_bwd(q, k, v, o, do, lse, causal=True, q_offset=100)
    assert torch.all(dk[:, 164:] == 0) and torch.all(dv[:, 164:] == 0)
    assert dk[:, :164].abs().max() > 0


def test_bf16_backward_must_split():
    """Why the bfloat16 kernel issues P and dS as hi + lo: rounded once,
    the gradients leave gradient_limit (a causal row of 2048 keys sums up
    to 2048 terms, each off by up to 2^-9); split, they stay within it."""
    case = (1, 2048, 2048, 1, 1, 64, True, 0)
    _, (q, k, v, do) = _draw(case, 4, torch.bfloat16)
    o, lse = _forward(q, k, v, True, 0)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse)
    ratios = {}
    for split in (True, False):
        got = emulate_bwd(q, k, v, o, do, lse, split=split)
        ratios[split] = max(((g.float() - w.float()).abs()
                             / gradient_limit(w, "bfloat16")).max().item()
                            for g, w in zip(got, want))
    assert ratios[True] <= 1.0 < ratios[False], ratios


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_timed_variants_apply_to_the_source(name):
    text = variant_source(name)
    assert "flash_attention_bwd_launch" in text
    assert (text == variant_source("as_built")) == (name == "as_built")
