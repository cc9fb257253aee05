"""The flash-attention kernel's wrapper and plain version.

``flash_attention_plain`` is held against the JAX Pallas kernel, run as
``tests/test_kernels.py`` runs it (interpret mode), and against
``attention_ref``, on that file's shape sweep and at its tolerances
(float32 rtol 2e-4 / atol 2e-5, bfloat16 3e-2), plus ``q_offset > 0``
cases against ``flash_attention_kernel(..., q_offset=...)`` and
``attention_ref(q_offset=...)``. The rounding rule of the card's 16-bit
kernel (P split into hi + lo in bfloat16) is held here by emulating its
tile arithmetic in torch. On a CPU tensor the wrapper computes the
plain version and launches nothing; the kernel itself is held against the
plain version on the card in ``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ops import flash_attention as pallas_fa
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor
from repro_torch.kernels.flash_attention.ops import (attention_limit,
                                                     flash_attention,
                                                     flash_attention_plain)

torch.set_num_threads(1)

SWEEP = [                              # tests/test_kernels.py:19-24
    (2, 128, 128, 4, 2, 64, True),     # GQA
    (1, 200, 200, 4, 4, 128, True),    # non-multiple padding
    (2, 64, 256, 8, 2, 64, False),     # cross-ish, bidir
    (1, 256, 64, 2, 1, 64, True),      # MQA, short kv
]
# (B, Sq, Skv, Hq, Hkv, Dh, q_offset): a chunk of queries against a longer KV
OFFSETS = [(1, 64, 256, 4, 2, 32, 192), (2, 128, 256, 4, 4, 64, 64)]


def _tol(dtype):                      # tests/test_kernels.py's tolerances
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _qkv(B, Sq, Skv, Hq, Hkv, Dh, dtype, seed=42):
    """[B, S, H, Dh] inputs for JAX and, the same values, for the port."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.normal(size=shape), dtype)
          for shape in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh))]
    return js, [host_tensor(np.asarray(a), pin=False) for a in js]


def _bhsd(a):
    return a.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(B, Sq, Skv, Hq, Hkv, Dh, causal,
                                             dtype):
    (q, k, v), (tq, tk, tv) = _qkv(B, Sq, Skv, Hq, Hkv, Dh, dtype)
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    kernel = pallas_fa(q, k, v, causal=causal, interpret=True, block_q=64,
                       block_kv=64)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32),
                               **_tol(dtype))
    ref = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal))
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,off", OFFSETS)
def test_plain_q_offset_matches_pallas_kernel_and_ref(B, Sq, Skv, Hq, Hkv,
                                                      Dh, off):
    (q, k, v), (tq, tk, tv) = _qkv(B, Sq, Skv, Hq, Hkv, Dh, "float32")
    got = flash_attention_plain(tq, tk, tv, causal=True, q_offset=off).numpy()
    kernel = _bhsd(flash_attention_kernel(
        _bhsd(q), _bhsd(k), _bhsd(v), causal=True, q_offset=off,
        block_q=64, block_kv=64, interpret=True))
    np.testing.assert_allclose(got, np.asarray(kernel), **_tol("float32"))
    ref = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=True,
                              q_offset=off))
    np.testing.assert_allclose(got, np.asarray(ref), **_tol("float32"))


def test_plain_masks_the_padded_tail():
    """``true_skv`` masks KV past it: the same as attention over the
    unpadded KV (the reference wrapper's padding case)."""
    _, (q, k, v) = _qkv(1, 200, 200, 4, 4, 32, "float32")
    pad = torch.zeros(1, 56, 4, 32)
    got = flash_attention_plain(q, torch.cat([k, pad], 1),
                                torch.cat([v, pad], 1), true_skv=200)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-5)


def test_cpu_wrapper_is_plain_and_launches_nothing():
    _, (q, k, v) = _qkv(2, 64, 96, 4, 2, 64, "float32")
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=True, q_offset=32)
    assert torch.equal(o, flash_attention_plain(q, k, v, q_offset=32))
    out = torch.empty_like(q)
    assert flash_attention(q, k, v, out=out) is out
    assert torch.equal(out, flash_attention_plain(q, k, v))
    assert flash_attention.launches == before


def test_wrapper_reads_strided_views():
    """Views of one fused projection (head dimension contiguous, other
    strides not) need no copy and give the contiguous result."""
    x = torch.randn(2, 48, 8 * 64 + 1,
                    generator=torch.Generator().manual_seed(0))
    heads = x[..., 1:].view(2, 48, 8, 64)
    q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
    assert not q.is_contiguous()
    torch.testing.assert_close(
        flash_attention(q, k, v),
        flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.parametrize("case", ["dh", "last-stride", "dtype", "offset",
                                  "heads", "out"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    _, (q, k, v) = _qkv(1, 16, 16, 4, 2, 32, "float32")
    kw = {}
    if case == "dh":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif case == "last-stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "dtype":
        k = k.double()
    elif case == "offset":
        kw["q_offset"] = -1
    elif case == "heads":
        q = torch.cat([q, q[:, :, :1]], 2)
    elif case == "out":
        kw["out"] = torch.empty(1, 16, 4, 16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, **kw)


def _kernel_arithmetic(q, k, v, p_rounding: str, tile: int = 64):
    """Causal attention as the card's 16-bit kernel computes it: 64-key
    tiles, scores and the online softmax (m, l, acc) in f32, l summed from
    the f32 P, and P rounded to the input type before the P.V product,
    either once (``"once"``) or as hi + lo, two products (``"split"``)."""
    B, S, H, Dh = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, Dh)
    q_pos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) / math.sqrt(Dh)
        s = s.masked_fill(torch.arange(k0, k0 + s.shape[-1]) > q_pos, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(q.dtype).float()
        if p_rounding == "split":
            hi = hi + (p - hi).to(q.dtype).float()
        acc = acc * corr + hi @ vf[:, :, k0:k0 + tile]
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("Dh", [112, 128])
def test_bf16_kernel_must_split_p(Dh):
    """Why the bfloat16 kernel issues P as hi + lo: rounded once to bf16, P
    carries ~2^-9 of error into every term of a row, and at 512 keys that
    already exceeds attention_limit; split, it stays well inside. float16
    keeps 11 bits, so its kernel rounds P once."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 1, 512, 2, Dh), dtype=np.float32)
    for dtype, rounding, within in ((torch.bfloat16, "split", True),
                                    (torch.bfloat16, "once", False),
                                    (torch.float16, "once", True)):
        q, k, v = (torch.from_numpy(a).to(dtype) for a in x)
        want = flash_attention_plain(q, k, v)
        got = _kernel_arithmetic(q, k, v, rounding)
        name = str(dtype).removeprefix("torch.")
        ratio = ((got.float() - want.float()).abs()
                 / attention_limit(want, name)).max().item()
        assert (ratio <= 1.0) == within, (name, rounding, ratio)
