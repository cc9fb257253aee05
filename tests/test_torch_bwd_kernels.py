"""The three backward kernels' designs (``moe_gmm_bwd``, ``ssd_scan_bwd``,
``wkv6_bwd``), emulated pass by pass in plain torch on the CPU, against
``jax.vjp`` of the reference's ``ref`` functions.

A CUDA kernel cannot run here, so each emulation repeats its kernel's
passes as the source describes them: the grouped matmul's dx product
(``dy @ w[e]^T``) into an unfilled buffer whose rows in no group the kernel
zeroes itself (each row written exactly once), and its dw product over
the group's rows in 64-row steps, rows past the group zeroed; the SSD
scan's recompute of the states entering each chunk
(the forward's passes 1-2), the chunks' local state gradients and their
reverse carry, the per-chunk gradients with ``seg`` and the reverse
cumulative sum of ``dseg`` in float64, then the fixed-order sums of dB and
dC over head groups and of dA over batch and chunks; WKV6's recompute of
the states entering each chunk, the reverse carry of dS, the per-chunk
gradients in tiles of 32 or 64 rows with the pair terms of A, dr and dk
outside the diagonal 8-row sub-blocks factored through the forward's
anchors, and ``dlw`` as the reverse cumulative sum of the decay terms,
every exponent a non-positive difference of cumulative log decays. Each
emulation is held against ``jax.vjp`` of ``moe_gmm_ref``, ``ssd_scan_ref``
and ``wkv6_ref`` at the kernel tests' float32 rule (``REF_RTOL`` of each
gradient's max|ref|) over the forwards' CPU sweeps: ragged last chunks, S
padding, odd head and state sizes, empty groups and rows in no group; and
over skewed groups (one group of most rows) and WKV6's
anchors at chunks 8, 32 and 64 on the model's decay range.
``test_torch_plain_grad.py`` drives the ``autograd.Function``s with these
emulations as their backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro.kernels.rwkv6.ref import wkv6_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref

torch.set_num_threads(1)

REF_RTOL = 5e-4              # tests/test_torch_plain_grad.py's rule
SSD_SUB = 64                 # ssd_scan_bwd's chunk: min(chunk, S, 64)
SSD_GROUP = 8                # heads a per-chunk block of ssd_scan_bwd takes
GMM_K = 64                   # moe_gmm_bwd's dw: rows a step
WKV_SB = 8                   # wkv6_bwd's sub-block: the anchors' spacing


# ---------------------------------------------------------------------------
# moe_gmm_bwd
# ---------------------------------------------------------------------------
def gmm_bwd_emulated(x, w, offsets, counts, dy):
    """(dx, dw) as moe_gmm_bwd's wgmma kernels compute them. dx starts
    unfilled (NaN here): group e's rows are dy's rows times w[e]^T, then
    the rows that a walk over the groups finds in none are zeroed; every
    row is written exactly once. dw[e] sums x^T dy over the group's rows in
    steps of GMM_K rows, in order, the rows of a step that lie past the
    group zeroed (an empty group's dw is zero). f32 sums, written in the
    inputs' type."""
    R, D = x.shape
    E, _, F = w.shape
    dx = torch.full((R, D), float("nan"))
    writes = torch.zeros(R, dtype=torch.int32)
    dw = torch.zeros(E, D, F, dtype=torch.float32)
    xf, wf, gf = x.float(), w.float(), dy.float()
    groups = list(zip(offsets.tolist(), counts.tolist()))
    for e, (o, c) in enumerate(groups):
        if c > 0:
            dx[o:o + c] = gf[o:o + c] @ wf[e].T
            writes[o:o + c] += 1
    bare = torch.tensor([not any(o <= r < o + c for o, c in groups)
                         for r in range(R)], dtype=torch.bool)
    dx[bare] = 0.0
    writes[bare] += 1
    assert bool((writes == 1).all()), "a row of dx written twice or never"
    for e, (o, c) in enumerate(groups):
        acc = torch.zeros(D, F)
        for k0 in range(0, max(c, 0), GMM_K):
            keep = torch.zeros(GMM_K, dtype=torch.bool)
            keep[:min(GMM_K, c - k0)] = True
            lo, hi = o + k0, min(o + k0 + GMM_K, R)
            xs = torch.zeros(GMM_K, D)
            gs = torch.zeros(GMM_K, F)
            xs[:hi - lo], gs[:hi - lo] = xf[lo:hi], gf[lo:hi]
            xs[~keep] = 0.0                     # rows past the group
            acc = acc + xs.T @ gs
        dw[e] = acc
    return dx.to(x.dtype), dw.to(w.dtype)


# ---------------------------------------------------------------------------
# ssd_scan_bwd
# ---------------------------------------------------------------------------
def _seq(v, dim):
    """A sum over ``dim`` in index order, as one thread adds its terms."""
    out = v.select(dim, 0)
    for i in range(1, v.shape[dim]):
        out = out + v.select(dim, i)
    return out


def _pairs(v, dim):
    """A sum over ``dim`` (a power of two) in the order of a butterfly over
    the lanes by offsets 1, 2, 4, ...: neighbours first."""
    dim %= v.dim()
    while v.shape[dim] > 1:
        v = v.unflatten(dim, (v.shape[dim] // 2, 2))
        v = v.select(dim + 1, 0) + v.select(dim + 1, 1)
    return v.squeeze(dim)


def _halves(v, dim):
    """A sum over ``dim`` (a power of two) in the order of a butterfly by
    offsets n/2, n/4, ..., 1 (``warp_sum``)."""
    n = v.shape[dim]
    while n > 1:
        n //= 2
        v = v.narrow(dim, 0, n) + v.narrow(dim, n, n)
    return v.squeeze(dim)


def _row_sum(v):
    """Pass 4's sum of a [.., 64 rows, 64 columns] tile over its columns:
    a warp's 16-column block holds column 8 nt + 2 q + c in lane q, which
    adds its four terms in (nt, c) order, then the 4 lanes of a row add
    theirs (offsets 1, 2), then the 4 column blocks are added in order."""
    v = v.unflatten(-1, (4, 2, 4, 2)).permute(
        *range(v.dim() - 1), -4, -2, -3, -1)        # [.., blk, q, nt, c]
    v = _seq(v.flatten(-2), -1)
    return _seq(_pairs(v, -1), -1)


def _col_sum(v):
    """Pass 4's sum of a [.., 64 rows, cols] tile over its rows: a warp's
    16-row block holds rows g and g + 8 in lane group g, added in that
    order, then the 8 lane groups (offsets 4, 8, 16 of the lanes), then
    the 4 row blocks in order."""
    v = v.unflatten(-2, (4, 2, 8))                  # [.., blk, i, g, cols]
    return _seq(_pairs(_seq(v, -3), -2), -2)


def _tf32_round(v):
    """v rounded to TF32 as pass 4 splits it: half an ulp of a 10-bit
    mantissa added to the magnitude, the low 13 bits cleared."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(v):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as pass 4's 3xTF32 MMAs: a = ah + al, b = bh + bl (ah, bh
    rounded to TF32, al, bl the rest as the tensor cores read it), and
    al bh + ah bl + ah bh in float32 (al bl dropped)."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_bwd_emulated(xh, dt, A, Bm, Cm, dy, *, chunk):
    """(dxh, ddt, dA, dBm, dCm) by ssd_scan_bwd's five passes, at the
    backward's chunk c = min(chunk, S, SSD_SUB) (the scan's value does not
    depend on its chunking; only its rounding does), the per-chunk tiles
    zero past c rows and past P and N (64 x 64), every product of passes 1
    and 4 by 3xTF32 MMAs (``_mm3``):

    1. per (b, chunk, head): the chunk's own state S_c = (x tail)^T B, its
       decay exp(seg_last), and its own state gradient G_c = (dy
       exp(seg))^T C (x and dy scaled first);
    2. the states entering each chunk, h <- exp(seg_last) h + S_c;
    3. the reverse carry: g_c, the gradient of the state leaving chunk c,
       g_{nc-1} = 0 and g_{c-1} = exp(seg_last,c) g_c + G_c;
    4. per (b, chunk, group of SSD_GROUP heads), the heads in turn, as
       ssd_bwd_chunk's phases: S1 dC(state), its row dots C . dC
       (``_row_sum``), g_c . h_c (a thread's 8 products of the 64 x 64
       tiles in order, an f64 butterfly over the warp, the 16 warps in
       order); S2 dWE, Q, W and sum_h dCB, Q's row sums (``_row_sum``) and
       column sums (``_col_sum``); S3 g_c B, dtail (``_col_sum``), dx =
       tail (g_c B) + W^T dy; S4 dB += tail x g_c; the row terms in f64,
       dDA the reverse cumulative sum, dA's partial; then the group's
       dC += dCB B and dB += dCB^T C;
    5. the fixed-order sums: dB and dC over the groups, dA over (b, chunk).
    """
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, S, SSD_SUB)
    nc = -(-S // c)
    T64 = SSD_SUB

    def chunks(t):            # [B, S, ...] -> [B, nc, 64, ...] f32, zeros past c
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, nc * c - S))
        t = t.reshape(B, nc, c, *t.shape[2:])
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3)
                                       + (0, T64 - c))

    def pad64(t):             # zero-pad the last dimension to 64
        return torch.nn.functional.pad(t, (0, T64 - t.shape[-1]))

    x, g = pad64(chunks(xh)), pad64(chunks(dy))       # [B,nc,64,H,64]
    d = chunks(dt)                                    # [B,nc,64,H]
    Bf, Cf = pad64(chunks(Bm)), pad64(chunks(Cm))     # [B,nc,64,64]
    a = A.float()
    inrow = torch.arange(T64) < c
    seg = torch.cumsum((d * a).double(), dim=2)       # [B,nc,64,H] f64
    last = seg[:, :, c - 1]                           # [B,nc,H]
    es = torch.where(inrow[:, None], torch.exp(seg.float()), 0.0)
    etl = torch.where(inrow[:, None],
                      torch.exp((last[:, :, None] - seg).float()), 0.0)
    tail = etl * d                                    # [B,nc,64,H]
    decay = torch.exp(last.float())                   # [B,nc,H]
    # pass 1: each chunk's own state and state gradient [B,nc,H,p,n]
    xt = (x * tail[..., None]).permute(0, 1, 3, 4, 2)    # [B,nc,H,p,t]
    gt = (g * es[..., None]).permute(0, 1, 3, 4, 2)
    own = _mm3(xt, Bf[:, :, None])
    G = _mm3(gt, Cf[:, :, None])
    # passes 2-3: the state entering each chunk; the reverse carry
    h = torch.zeros(B, H, T64, T64)
    hin = []
    for i in range(nc):
        hin.append(h)
        h = decay[:, i, :, None, None] * h + own[:, i]
    hin = torch.stack(hin, 1)                         # [B,nc,H,p,n]
    gacc = torch.zeros(B, H, T64, T64)
    gout = [None] * nc
    for i in reversed(range(nc)):
        gout[i] = gacc
        gacc = decay[:, i, :, None, None] * gacc + G[:, i]
    gout = torch.stack(gout, 1)                       # [B,nc,H,p,n]
    # pass 4
    tri = (torch.arange(T64)[None] <= torch.arange(T64)[:, None]) \
        & inrow[:, None]                              # [t, s]: s <= t < c
    CB = torch.where(tri, _mm3(Cf, Bf.transpose(-1, -2)), 0.0)
    dx = torch.zeros(B, nc, T64, H, T64)
    ddt = torch.zeros(B, nc, T64, H)
    dA_part = torch.zeros(B, nc, H, dtype=torch.float64)
    dB_parts, dC_parts = [], []
    for h0 in range(0, H, SSD_GROUP):
        dCB = torch.zeros(B, nc, T64, T64)
        accB = torch.zeros(B, nc, T64, T64)           # [s][n]
        accC = torch.zeros(B, nc, T64, T64)           # [t][n]
        for h in range(h0, min(h0 + SSD_GROUP, H)):
            xs, gy = x[:, :, :, h], g[:, :, :, h]     # [B,nc,64,64]
            hc, gc = hin[:, :, h], gout[:, :, h]      # [B,nc,p,n]
            sg, dth, tl = seg[..., h], d[..., h], tail[..., h]
            # S1: dC(state), C . dC(state) by row, g_c . h_c
            dci = _mm3(gy, hc) * es[..., h, None]
            accC = accC + dci
            cdc = _row_sum(Cf * dci)                            # [B,nc,t]
            part = _seq((gc * hc).reshape(B, nc, 8, 512), 2)  # a thread's
            gh = _seq(_halves(part.double().reshape(B, nc, 16, 32), -1), -1)
            # S2: dWE, Q, W, sum_h dCB; Q's row and column sums
            E = torch.exp(torch.where(
                tri, sg[:, :, :, None] - sg[:, :, None], -1e30).float())
            dwe = _mm3(gy, xs.transpose(-1, -2)) * E
            q = dwe * CB
            W = (CB * E) * dth[:, :, None]
            dCB = dCB + dwe * dth[:, :, None]
            rows = _row_sum(q * dth[:, :, None])
            colsum = _col_sum(q)
            # S3: g_c B [p][s]; dtail; dx
            gB = _mm3(gc, Bf.transpose(-1, -2))                 # [B,nc,p,s]
            dtail = _col_sum(xs.transpose(-1, -2) * gB)
            dx[:, :, :, h] = (tl[:, :, None] * gB
                              + _mm3(gy.transpose(-1, -2),
                                     W)).transpose(-1, -2)
            # S4: dB^T += tail (x g_c)^T; the row terms
            accB = accB + tl[..., None] * _mm3(xs, gc)
            ddt0 = colsum + dtail * etl[..., h]
            dtt = dtail * tl
            dseg = torch.where(inrow, rows.double() - (dth * colsum).double()
                               + cdc.double() - dtt.double(), 0.0)
            end = torch.where(inrow, dtt.double(), 0.0).sum(-1) \
                + decay[..., h].double() * gh
            dseg[:, :, c - 1] += end
            dDA = torch.flip(torch.cumsum(torch.flip(dseg, [2]), 2), [2])
            ddt[:, :, :, h] = ddt0 + (dDA * float(a[h])).float()
            dA_part[:, :, h] = (dDA * dth.double()).sum(-1)
        dC_parts.append(accC + _mm3(dCB, Bf))
        dB_parts.append(accB + _mm3(dCB.transpose(-1, -2), Cf))
    # pass 5: fixed-order sums over groups and over (b, chunk)
    dB = torch.zeros_like(dB_parts[0])
    dC = torch.zeros_like(dC_parts[0])
    for pb, pc in zip(dB_parts, dC_parts):
        dB, dC = dB + pb, dC + pc
    dA = dA_part.reshape(-1, H).sum(0)

    def unchunk(t, *keep):
        t = t[:, :, :c]
        t = t.reshape(B, nc * c, *t.shape[3:])[:, :S]
        return t[(..., *(slice(0, k) for k in keep))] if keep else t

    return (unchunk(dx, P).to(xh.dtype), unchunk(ddt).to(dt.dtype),
            dA.float().to(A.dtype), unchunk(dB, N).to(Bm.dtype),
            unchunk(dC, N).to(Cm.dtype))


# ---------------------------------------------------------------------------
# wkv6_bwd
# ---------------------------------------------------------------------------
def wkv6_bwd_emulated(r, k, v, lw, u, dy, *, chunk):
    """(dr, dk, dv, dlw, du) by wkv6_bwd's passes at c = min(chunk, S),
    each chunk in a tile of MC = 32 rows (c <= 32) or 64, the rows past c
    zero (lw = 0: they change no sum):

    1-2. the forward's passes with groups of one chunk: the state S_c
       entering each chunk and each chunk's decay exp(lcw_last);
    3. each chunk's own state gradient G_c = (r exp(prev))^T dy;
    4. the reverse carry of dS: D_c, the gradient of the state leaving
       chunk c, D_{nc-1} = 0 and D_{c-1} = exp(lcw_last,c) D_c + G_c;
    5. per (b, h, chunk): dA = dy v^T; the pair terms exp(prev_t - lcw_s)
       of A, dr and dk for t in sub-block a, s in sub-block b < a (rows
       of WKV_SB) factored through the anchors anc_a (lcw before sub-block
       a) and fin_b (lcw at b's last row): eR_t M_ab eK_s with eR_t =
       exp(prev_t - anc_a), M_ab = exp(anc_a - fin_b), eK_s = exp(fin_b -
       lcw_s), so that dr's part is eR sum_b M_ab (sum_{s in b} dA kh_s)
       and dk's eK sum_a M_ab (sum_{t in a} dA rh_t) (rh = r eR, kh = k
       eK); per-pair exponentials inside the diagonal sub-blocks; dv = A^T
       dy + (k exp(lcw_last - lcw)) D; the incoming state and D's terms;
       du's partial; dlw_i = z + sum_{t>i} r_t dr'_t - sum_{t>=i} k_t dk'_t
       with z = sum_q D S_{c+1} (dr', dk' without the bonus), in f64;
    6. du summed over (b, chunk) in order.
    Every exponent is a difference lcw_j - lcw_i with j >= i: <= 0. Returns
    the gradients and every exponent taken, flat."""
    B, S, H, P = r.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    mc = 32 if c <= 32 else 64
    nsb = mc // WKV_SB
    fpad = torch.nn.functional.pad

    def chunks(t):           # [B, S, H, P] -> [B, H, nc, mc, P] f32
        t = fpad(t.float(), (0, 0, 0, 0, 0, pad))
        t = t.reshape(B, nc, c, H, P).permute(0, 3, 1, 2, 4)
        return fpad(t, (0, 0, 0, mc - c))

    rf, kf, vf, lwf, gf = (chunks(t) for t in (r, k, v, lw, dy))
    uf = u.float()[None, :, None, None, :]
    lcw = torch.cumsum(lwf, dim=3)
    prev = fpad(lcw, (0, 0, 1, 0))[..., :-1, :]
    last = lcw[..., -1:, :]                                # [B,H,nc,1,P]
    args = [prev, last - lcw]
    kt = kf * torch.exp(last - lcw)
    d = torch.exp(last)[..., 0, :, None]                   # [B,H,nc,P,1]
    # passes 1-2: the state entering each chunk
    U = kt.transpose(-1, -2) @ vf                          # [B,H,nc,P,P]
    s = torch.zeros(B, H, P, P)
    sin = []
    for i in range(nc):
        sin.append(s)
        s = d[:, :, i] * s + U[:, :, i]
    sin = torch.stack(sin, 2)                              # [B,H,nc,P,P]
    # pass 3: G_c; pass 4: the reverse carry of dS
    re = rf * torch.exp(prev)
    G = re.transpose(-1, -2) @ gf
    acc = torch.zeros(B, H, P, P)
    dout = [None] * nc
    for i in reversed(range(nc)):
        dout[i] = acc
        acc = d[:, :, i] * acc + G[:, :, i]
    dout = torch.stack(dout, 2)                            # [B,H,nc,P,P]
    sout = torch.cat([sin[:, :, 1:], torch.zeros(B, H, 1, P, P)], 2)
    # pass 5: the anchors and their factors
    sb = torch.arange(mc) // WKV_SB                        # a row's sub-block
    first = torch.arange(nsb) * WKV_SB
    anc = torch.cat([torch.zeros_like(lcw[..., :1, :]),
                     lcw[..., first[1:] - 1, :]], 3)       # [..,nsb,P]
    fin = lcw[..., first + WKV_SB - 1, :]                  # [..,nsb,P]
    er_arg, ek_arg = prev - anc[..., sb, :], fin[..., sb, :] - lcw
    ab = torch.arange(nsb)[:, None] > torch.arange(nsb)[None, :]
    m_arg = anc[..., :, None, :] - fin[..., None, :, :]    # [..,a,b,P]
    args += [er_arg, ek_arg, m_arg[..., ab, :]]
    eR, eK = torch.exp(er_arg), torch.exp(ek_arg)
    Mab = torch.exp(m_arg.masked_fill(~ab[..., None], -1e30))   # 0 if a <= b
    rh, kh = rf * eR, kf * eK
    strict = torch.tril(torch.ones(mc, mc, dtype=torch.bool), -1)
    same = strict & (sb[:, None] == sb[None, :])           # diagonal blocks
    diff = prev[..., :, None, :] - lcw[..., None, :, :]    # [..,t,s,P]
    args.append(diff[..., same, :])
    ex = torch.exp(diff.masked_fill(~same[..., None], -1e30))
    Mts = Mab[..., sb, :, :][..., :, sb, :]                # M_{a(t), b(s)}
    A = torch.einsum("bhctp,bhctsp,bhcsp->bhcts", rh, Mts, kh) \
        + torch.einsum("bhctp,bhctsp,bhcsp->bhcts", rf, ex, kf)
    diag = (rf * uf * kf).sum(-1)                          # A[t, t]
    A = A + torch.diag_embed(diag)
    dA = torch.tril(gf @ vf.transpose(-1, -2))             # dy_t . v_s
    dAd = torch.diagonal(dA, dim1=-2, dim2=-1)             # dA[t, t]
    dv = A.transpose(-1, -2) @ gf + kt @ dout
    blk = dA.shape[:3]
    X = torch.einsum("bhctaj,bhcajp->bhctap",              # sum_{s in a}
                     dA.reshape(*blk, mc, nsb, WKV_SB),
                     kh.reshape(*blk, nsb, WKV_SB, P))
    drA = eR * (Mab[..., sb, :, :] * X).sum(-2) \
        + torch.einsum("bhcts,bhctsp,bhcsp->bhctp", dA, ex, kf)
    Y = torch.einsum("bhcajs,bhcajp->bhcsap",              # sum_{t in a}
                     dA.reshape(*blk, nsb, WKV_SB, mc),
                     rh.reshape(*blk, nsb, WKV_SB, P))
    dkA = eK * (Mab[..., sb, :].transpose(-3, -2) * Y).sum(-2) \
        + torch.einsum("bhcts,bhctsp,bhctp->bhcsp", dA, ex, rf)
    drS = torch.exp(prev) * (gf @ sin.transpose(-1, -2))
    dkS = torch.exp(last - lcw) * (vf @ dout.transpose(-1, -2))
    dr = drA + drS + dAd[..., None] * uf * kf
    dk = dkA + dkS + dAd[..., None] * uf * rf
    du_part = (dAd[..., None] * rf * kf).sum(3)            # [B,H,nc,P]
    z = (dout.double() * sout.double()).sum(-1)            # [B,H,nc,P]
    rd = (rf * (drA + drS)).double()
    kd = (kf * (dkA + dkS)).double()
    # dlw_i = z + sum_{t > i} rd_t - sum_{t >= i} kd_t
    rev = lambda t: torch.flip(torch.cumsum(torch.flip(t, [3]), 3), [3])  # noqa: E731
    dlw = z[..., None, :] + (rev(rd) - rd) - rev(kd)
    du = du_part.permute(0, 2, 1, 3).reshape(B * nc, H, P).double().sum(0)

    def unchunk(t):
        return t[..., :c, :].permute(0, 2, 3, 1, 4).reshape(
            B, nc * c, H, P)[:, :S]

    flat = torch.cat([a.reshape(-1) for a in args])
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(k.dtype),
            unchunk(dv).to(v.dtype), unchunk(dlw.float()).to(lw.dtype),
            du.float().to(u.dtype)), flat


# ---------------------------------------------------------------------------
# the emulations against jax.vjp of the references
# ---------------------------------------------------------------------------
def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close_to_ref(got: torch.Tensor, want, label: str) -> None:
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = float(np.abs(got.float().numpy() - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= REF_RTOL * scale, (label, err, scale)


# the forwards' CPU sweeps (tests/test_torch_moe_gmm.py, ...ssd_scan.py,
# ...wkv6.py) and the Functions' own cases
GMM_SWEEP = [(4, 100, 96, 130), (2, 64, 64, 64), (8, 16, 48, 32),
             (4, 24, 32, 40), (2, 17, 48, 16)]


@pytest.mark.parametrize("E,C,D,F", GMM_SWEEP)
def test_gmm_bwd_emulation_matches_reference_vjp(E, C, D, F):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.normal(size=(E, C, F)).astype(np.float32)
    offsets = torch.arange(E, dtype=torch.int32) * C
    counts = torch.full((E,), C, dtype=torch.int32)
    dx, dw = gmm_bwd_emulated(_t(x).reshape(E * C, D), _t(w), offsets,
                              counts, _t(dy).reshape(E * C, F))
    _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    rx, rw = vjp(jnp.asarray(dy))
    _close_to_ref(dx.reshape(E, C, D), rx, "dx")
    _close_to_ref(dw, rw, "dw")


# (offsets, counts, R): an empty group, rows in no group (between groups
# and after the last), a group of more than one 64-row step that ends
# inside a step, one group of every row; two empty groups in a row; groups
# on whole 64-row steps with rows in no group before and after them
RAGGED = [([0, 7, 7, 20], [7, 0, 9, 6], 30),
          ([3, 70, 70, 200], [67, 0, 130, 1], 210),
          ([0, 0, 0], [0, 150, 0], 150),
          ([0, 10, 10, 10], [10, 0, 0, 54], 80),
          ([64, 128], [64, 64], 256)]


@pytest.mark.parametrize("case", range(len(RAGGED)))
def test_gmm_bwd_emulation_ragged_groups(case):
    """Ragged groups against jax.vjp of moe_gmm_ref on each group's rows:
    rows in no group get dx = 0, an empty group's dw is 0."""
    offs, cnts, R = RAGGED[case]
    rng = np.random.default_rng(1 + case)
    E, D, F = len(offs), 40, 24
    x = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.normal(size=(R, F)).astype(np.float32)
    dx, dw = gmm_bwd_emulated(_t(x), _t(w),
                              torch.tensor(offs, dtype=torch.int32),
                              torch.tensor(cnts, dtype=torch.int32), _t(dy))
    covered = np.zeros(R, bool)
    for e, (o, c) in enumerate(zip(offs, cnts)):
        covered[o:o + c] = True
        if c == 0:
            assert float(dw[e].abs().max()) == 0.0
            continue
        _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x[None, o:o + c]),
                         jnp.asarray(w[None, e]))
        rx, rw = vjp(jnp.asarray(dy[None, o:o + c]))
        _close_to_ref(dx[o:o + c], np.asarray(rx)[0], f"dx[{e}]")
        _close_to_ref(dw[e], np.asarray(rw)[0], f"dw[{e}]")
    assert float(dx[torch.from_numpy(~covered)].abs().sum()) == 0.0


# (offsets, counts, R): one group of most rows (its last 64-row step
# ragged) with an empty group and rows in no group after it; one group of
# all rows but a few, in no group before and after it; two large groups
# and a small one, the last a single row past a step; one group of every
# row but one, beside an empty group and a group of one row; most rows in
# the last group; 100 rows in no group before the big one
SKEWED = [([0, 2500, 2800, 2800], [2500, 300, 0, 150], 3000),
          ([5, 2053, 2053], [2048, 0, 40], 2100),
          ([0, 1100, 3600], [1100, 2500, 2049], 5700),
          ([0, 2999, 2999], [2999, 0, 1], 3000),
          ([0, 64, 64, 128], [64, 0, 64, 3008], 3136),
          ([100, 4100], [4000, 30], 4200)]


@pytest.mark.parametrize("case", range(len(SKEWED)))
def test_gmm_bwd_emulation_skewed_groups(case):
    """Skewed groups, one group's whole depth one sum: against jax.vjp of
    moe_gmm_ref on each group's rows, dx = 0 on rows in no group, an empty
    group's dw = 0."""
    offs, cnts, R = SKEWED[case]
    rng = np.random.default_rng(20 + case)
    E, D, F = len(offs), 24, 16
    x = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.normal(size=(R, F)).astype(np.float32)
    dx, dw = gmm_bwd_emulated(
        _t(x), _t(w), torch.tensor(offs, dtype=torch.int32),
        torch.tensor(cnts, dtype=torch.int32), _t(dy))
    covered = np.zeros(R, bool)
    for e, (o, c) in enumerate(zip(offs, cnts)):
        covered[o:o + c] = True
        if c == 0:
            assert float(dw[e].abs().max()) == 0.0
            continue
        _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x[None, o:o + c]),
                         jnp.asarray(w[None, e]))
        rx, rw = vjp(jnp.asarray(dy[None, o:o + c]))
        _close_to_ref(dx[o:o + c], np.asarray(rx)[0], f"dx[{e}]")
        _close_to_ref(dw[e], np.asarray(rw)[0], f"dw[{e}]")
    assert float(dx[torch.from_numpy(~covered)].abs().sum()) == 0.0


def ssd_inputs(B, S, H, P, N, seed=0):
    """tests/test_kernels.py's ranges: x, dt = |N(0,1)|, A = -|N(0,1)|,
    B, C ~ N(0, 1); and dy ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(a, np.float32) for a in (
        rng.normal(size=(B, S, H, P)), np.abs(rng.normal(size=(B, S, H))),
        -np.abs(rng.normal(size=(H,))), rng.normal(size=(B, S, N)),
        rng.normal(size=(B, S, N)), rng.normal(size=(B, S, H, P)))]


SSD_SWEEP = [(2, 100, 3, 32, 16, 32), (1, 64, 2, 64, 64, 16),
             (2, 33, 1, 16, 8, 64), (1, 33, 2, 16, 8, 16),
             (1, 300, 9, 24, 12, 128), (2, 20, 2, 8, 5, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SWEEP)
def test_ssd_bwd_emulation_matches_reference_vjp(B, S, H, P, N, chunk):
    *arrs, dy = ssd_inputs(B, S, H, P, N)
    got = ssd_bwd_emulated(*map(_t, arrs), _t(dy), chunk=chunk)
    _, vjp = jax.vjp(lambda *a: ssd_scan_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, gt, rf in zip(("xh", "dt", "A", "Bm", "Cm"), got,
                            vjp(jnp.asarray(dy))):
        _close_to_ref(gt, rf, name)


def wkv6_inputs(B, S, H, P, seed=2, model_range=False):
    """r, k, v, u ~ N(0, 1); lw = -exp(N(0,1)/2 - 1), or the model's range
    -exp(2 N(0,1) - 6) clipped at -20; and dy ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, P)) for _ in range(3))
    if model_range:
        lw = np.clip(-np.exp(rng.normal(size=(B, S, H, P)) * 2.0 - 6.0),
                     -20, 0)
    else:
        lw = -np.exp(rng.normal(size=(B, S, H, P)) * 0.5 - 1.0)
    u = rng.normal(size=(H, P))
    dy = rng.normal(size=(B, S, H, P))
    return [np.asarray(a, np.float32) for a in (r, k, v, lw, u, dy)]


WKV_SWEEP = [(2, 100, 3, 32, 25, False), (1, 31, 2, 64, 8, False),
             (2, 64, 1, 16, 64, False), (1, 31, 2, 16, 8, False),
             (1, 300, 2, 64, 32, True), (2, 20, 3, 24, 32, False)]


@pytest.mark.parametrize("B,S,H,P,chunk,model", WKV_SWEEP)
def test_wkv6_bwd_emulation_matches_reference_vjp(B, S, H, P, chunk, model):
    """Every exponent the passes take is <= 0 and every gradient finite and
    within the rule of jax.vjp of wkv6_ref."""
    *arrs, dy = wkv6_inputs(B, S, H, P, model_range=model)
    got, args = wkv6_bwd_emulated(*map(_t, arrs), _t(dy), chunk=chunk)
    assert float(args.max()) <= 0.0
    _, vjp = jax.vjp(lambda *a: wkv6_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, gt, rf in zip(("r", "k", "v", "lw", "u"), got,
                            vjp(jnp.asarray(dy))):
        assert bool(torch.isfinite(gt).all()), name
        _close_to_ref(gt, rf, name)


# (B, S, H, P, chunk): the anchors at chunks 8 (one sub-block a chunk, a
# tile of 32 rows), 32 and 64, each with a ragged last chunk
WKV_FACTORED = [(1, 3 * 8 + 5, 2, 64, 8), (2, 3 * 32 + 7, 2, 64, 32),
                (1, 2 * 64 + 9, 2, 32, 64)]


@pytest.mark.parametrize("B,S,H,P,chunk", WKV_FACTORED)
def test_wkv6_bwd_factored_on_the_models_decay_range(B, S, H, P, chunk):
    """The factored pair terms on rwkv6-7b's log decays, -exp(2 N(0,1) - 6)
    clipped at -20, with rows at the clip: every exponent <= 0, every
    gradient finite and within the rule of jax.vjp of wkv6_ref."""
    *arrs, dy = wkv6_inputs(B, S, H, P, seed=7, model_range=True)
    arrs[3][:, 3::11] = -20.0
    got, args = wkv6_bwd_emulated(*map(_t, arrs), _t(dy), chunk=chunk)
    assert float(args.max()) <= 0.0
    _, vjp = jax.vjp(lambda *a: wkv6_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, gt, rf in zip(("r", "k", "v", "lw", "u"), got,
                            vjp(jnp.asarray(dy))):
        assert bool(torch.isfinite(gt).all()), name
        _close_to_ref(gt, rf, name)


# zamba2-7b's ranges as chip_smoke.py's ssd_bwd_model_range draws them:
# dt = softplus(N(0, 1)), A from -1 to -16 over the heads, x, B, C, dy ~
# N(0, 1); seg reaches ~-10^3 within a 64-row chunk
SSD_MODEL_RANGE = [(1, 192, 9, 64, 64, 128), (2, 100, 3, 32, 16, 64)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_MODEL_RANGE)
def test_ssd_bwd_3xtf32_on_the_models_ranges(B, S, H, P, N, chunk):
    """ssd_scan_bwd's products by 3xTF32 MMAs (the emulation's ``_mm3``)
    on zamba2-7b's ranges: each gradient's error against autograd through
    a float64 evaluation of the model's recurrence (models/ssm.py::
    _ssd_chunked) at most twice the plain float32 backward's, the card's
    rule (chip_smoke.py::ssd_bwd_model_range)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd_plain
    from repro_torch.models.ssm import _ssd_chunked
    rng = np.random.default_rng(3)
    x, dt_raw, Bm, Cm, dy = (torch.from_numpy(rng.normal(size=s).astype(
        np.float32)) for s in ((B, S, H, P), (B, S, H), (B, S, N),
                               (B, S, N), (B, S, H, P)))
    args = (x, torch.nn.functional.softplus(dt_raw),
            -torch.linspace(1.0, 16.0, H), Bm, Cm)
    got = ssd_bwd_emulated(*args, dy, chunk=chunk)
    plain = ssd_scan_bwd_plain(*args, dy, chunk=chunk)
    leaves = [t.double().requires_grad_() for t in args]
    y, _ = _ssd_chunked(*leaves, chunk=chunk,
                        h0=torch.zeros(B, H, P, N, dtype=torch.float64))
    exact = torch.autograd.grad(y, leaves, dy.double())
    for name, gt, pl, ex in zip(("dxh", "ddt", "dA", "dBm", "dCm"), got,
                                plain, exact):
        err = (gt.double() - ex).abs().max().item()
        err_plain = (pl.double() - ex).abs().max().item()
        assert err <= 2 * err_plain, (name, err, err_plain)
