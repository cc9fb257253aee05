"""Flash attention's backward in the port: the plain version of the
backward kernels (``flash_attention_bwd_plain``) against ``jax.grad`` of
the reference's ``layers.blockwise_attention`` and of the Pallas kernel's
``ref.py`` on ``tests/test_kernels.py``'s attention sweep, plus ``q_offset``
chunks; the forward's log-sum-exp output; ``FlashAttentionFn`` against
``torch.autograd.gradcheck`` in float64 and against autograd of the plain
forward. float32 tolerance: rtol 1e-4, atol 1e-5 (sums over up to 256
keys in other orders on the two sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as RL
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, flash_attention, flash_attention_bwd, lse_plain,
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.models import layers as PL

# tests/test_kernels.py's sweep (B, Sq, Skv, Hq, Hkv, Dh, causal) with
# q_offset 0, and two chunks of queries against a longer KV
SWEEP = [(2, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 4, 4, 128, True, 0),
         (2, 64, 256, 8, 2, 64, False, 0), (1, 256, 64, 2, 1, 64, True, 0),
         (1, 64, 256, 4, 2, 32, True, 192), (1, 33, 80, 4, 1, 32, True, 47)]
TOL = dict(rtol=1e-4, atol=1e-5)


def _draw(case, seed):
    B, Sq, Skv, Hq, Hkv, Dh, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh), (B, Skv, Hkv, Dh),
             (B, Sq, Hq, Dh))]


def _ref_attention(oracle, causal, q_offset):
    if oracle == "layers":
        return lambda q, k, v: RL.blockwise_attention(
            q, k, v, causal=causal, q_offset=q_offset, block_kv=64)
    t = lambda a: a.transpose(0, 2, 1, 3)
    return lambda q, k, v: t(attention_ref(t(q), t(k), t(v), causal=causal,
                                           q_offset=q_offset))


@pytest.mark.parametrize("case", SWEEP, ids=str)
@pytest.mark.parametrize("oracle", ["layers", "ref"])
def test_plain_backward_matches_jax_grad(case, oracle):
    causal, off = case[6], case[7]
    q, k, v, do = _draw(case, 0)
    attn = _ref_attention(oracle, causal, off)

    def f(qq, kk, vv):
        return jnp.sum(attn(qq, kk, vv) * do)
    jg = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = flash_attention_plain(tq, tk, tv, causal=causal, q_offset=off)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, causal=causal,
                                    q_offset=off)
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", SWEEP[:3], ids=str)
def test_lse_given_or_recomputed(case):
    causal, off = case[6], case[7]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in _draw(case, 1))
    lse = torch.empty(tq.shape[0], tq.shape[2], tq.shape[1])
    o = flash_attention(tq, tk, tv, causal=causal, q_offset=off, lse=lse)
    assert torch.equal(lse, lse_plain(tq, tk, causal, off))
    a = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal,
                                  q_offset=off)
    b = flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal=causal,
                            q_offset=off)
    c = flash_attention_bwd_plain(tq, tk, tv, o, tdo, causal=causal,
                                  q_offset=off)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", [(2, 5, 5, 4, 2, 4, True, 0),
                                  (1, 3, 7, 2, 1, 4, True, 4),
                                  (1, 4, 6, 2, 2, 4, False, 0)], ids=str)
def test_function_gradcheck_float64(case):
    B, Sq, Skv, Hq, Hkv, Dh, causal, off = case
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for s in ((B, Sq, Hq, Dh), (B, Skv, Hkv, Dh),
                         (B, Skv, Hkv, Dh)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, causal, off),
        (q, k, v))


@pytest.mark.parametrize("case", SWEEP, ids=str)
def test_function_matches_autograd_of_plain(case):
    causal, off = case[6], case[7]
    arrs = [torch.from_numpy(a) for a in _draw(case, 2)]
    a = [t.clone().requires_grad_() for t in arrs[:3]]
    b = [t.clone().requires_grad_() for t in arrs[:3]]
    o = PL.blockwise_attention(*a, causal=causal, q_offset=off)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    o.backward(arrs[3])
    flash_attention_plain(*b, causal=causal, q_offset=off).backward(arrs[3])
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert PL.blockwise_attention(*a, causal=causal).grad_fn is None


def test_scale_and_mask_conventions():
    """A causal row that sees one key has zero dQ (dS = P (dP - Di) = 0),
    and keys no query sees get zero dK and dV."""
    case = (1, 4, 8, 2, 2, 32, True, 2)
    tq, tk, tv, tdo = (torch.from_numpy(a).double() for a in _draw(case, 3))
    o = flash_attention_plain(tq, tk, tv, causal=True, q_offset=2)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, o, tdo, causal=True,
                                           q_offset=2)
    assert torch.all(dk[:, 6:] == 0) and torch.all(dv[:, 6:] == 0)
    o1 = flash_attention_plain(tq[:, :1], tk[:, :1], tv[:, :1])
    dq1 = flash_attention_bwd_plain(tq[:, :1], tk[:, :1], tv[:, :1], o1,
                                    tdo[:, :1])[0]
    assert dq1.abs().max() < 1e-12
    assert dq.abs().max() > 0
