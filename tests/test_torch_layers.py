"""The port's dense layers against the reference's ``models/layers.py`` on
the same numpy inputs and parameters: ``rope``, both norms,
``blockwise_attention`` (the flash kernel's plain version on the CPU),
``decode_attention``, ``decode_attention_q8``, both MLPs and
``attention_block``.

Tolerances: float32 rtol 2e-4 / atol 2e-5 (``tests/test_kernels.py``'s;
the frameworks sum in other orders, and the port's rmsnorm rounds once in
f32 where the reference rounds the scale to x.dtype first); bfloat16
rtol/atol 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor, params_from_reference
from repro_torch.models import layers as PL

torch.set_num_threads(1)


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _arr(rng, shape, dtype="float32", scale=1.0):
    """A JAX array and the same values as a CPU tensor."""
    j = jnp.asarray(rng.normal(size=shape) * scale, dtype)
    return j, host_tensor(np.asarray(j), pin=False)


def _close(got: torch.Tensor, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(0)
    x, tx = _arr(rng, (2, 9, 4, 32), dtype)
    pos = rng.integers(0, 500, (2, 9))
    got = PL.rope(tx, torch.from_numpy(pos), 1e4)
    _close(got, RL.rope(x, jnp.asarray(pos), 1e4), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = np.random.default_rng(1)
    x, tx = _arr(rng, (3, 5, 64), dtype, scale=3.0)
    g, tg = _arr(rng, (64,), dtype)
    b, tb = _arr(rng, (64,), dtype)
    _close(PL.rmsnorm(tx, tg), RL.rmsnorm(x, g), dtype)
    _close(PL.rmsnorm(tx, None), RL.rmsnorm(x, None), dtype)
    _close(PL.layernorm(tx, tg, tb), RL.layernorm(x, g, b), dtype)
    _close(PL.layernorm(tx), RL.layernorm(x), dtype)


@pytest.mark.parametrize("causal,q_offset,Sq,Skv", [
    (True, 0, 40, 40), (False, 0, 24, 72), (True, 48, 24, 72)])
def test_blockwise_attention(causal, q_offset, Sq, Skv):
    rng = np.random.default_rng(2)
    q, tq = _arr(rng, (2, Sq, 4, 32))
    k, tk = _arr(rng, (2, Skv, 2, 32))
    v, tv = _arr(rng, (2, Skv, 2, 32))
    want = RL.blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  block_kv=16)
    _close(PL.blockwise_attention(tq, tk, tv, causal=causal,
                                  q_offset=q_offset), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype):
    rng = np.random.default_rng(3)
    q, tq = _arr(rng, (3, 1, 4, 32), dtype)
    kc, tkc = _arr(rng, (3, 24, 2, 32), dtype)
    vc, tvc = _arr(rng, (3, 24, 2, 32), dtype)
    lens = np.array([5, 24, 1])
    want = RL.decode_attention(q, kc, vc, jnp.asarray(lens))
    _close(PL.decode_attention(tq, tkc, tvc, torch.from_numpy(lens)), want,
           dtype)
    _close(PL.decode_attention(tq, tkc, tvc, 7),
           RL.decode_attention(q, kc, vc, 7), dtype)


def test_decode_attention_q8():
    rng = np.random.default_rng(4)
    q, tq = _arr(rng, (2, 1, 4, 32))
    kq = rng.integers(-127, 128, (2, 16, 2, 32)).astype(np.int8)
    vq = rng.integers(-127, 128, (2, 16, 2, 32)).astype(np.int8)
    ks = np.abs(rng.normal(size=(2, 16, 2))).astype(np.float32) / 100
    vs = np.abs(rng.normal(size=(2, 16, 2))).astype(np.float32) / 100
    lens = np.array([9, 16])
    want = RL.decode_attention_q8(q, jnp.asarray(kq), jnp.asarray(vq),
                                  jnp.asarray(ks), jnp.asarray(vs),
                                  jnp.asarray(lens))
    got = PL.decode_attention_q8(tq, *(torch.from_numpy(a) for a in
                                       (kq, vq, ks, vs, lens)))
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps(kind, dtype):
    rng = np.random.default_rng(5)
    p = RL.mlp_init(jax.random.PRNGKey(0), 64, 96, kind, jnp.dtype(dtype),
                    bias=(kind == "gelu"))
    if kind == "gelu":       # nonzero biases, so the test sees them
        p = dict(p, bi=p["bi"] + 0.1, bo=p["bo"] - 0.2)
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    x, tx = _arr(rng, (2, 7, 64), dtype)
    fn, tfn = ((RL.swiglu_mlp, PL.swiglu_mlp) if kind == "swiglu"
               else (RL.gelu_mlp, PL.gelu_mlp))
    _close(tfn(tp, tx), fn(p, x), dtype)


@pytest.mark.parametrize("n_kv_heads,bias", [(2, False), (4, True)])
def test_attention_block(n_kv_heads, bias):
    rng = np.random.default_rng(6)
    spec = RL.AttnParamsSpec(128, 4, n_kv_heads, 32, qkv_bias=bias)
    p = spec.init(jax.random.PRNGKey(1))
    if bias:
        p = dict(p, bq=p["bq"] + 0.05, bk=p["bk"] - 0.05, bv=p["bv"] + 0.1)
    tp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    x, tx = _arr(rng, (2, 20, 128))
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    want = RL.attention_block(p, x, n_heads=4, n_kv_heads=n_kv_heads,
                              d_head=32, positions=jnp.asarray(pos),
                              rope_theta=1e4, block_kv=8)
    got = PL.attention_block(tp, tx, n_heads=4, n_kv_heads=n_kv_heads,
                             d_head=32, positions=torch.from_numpy(pos.copy()),
                             rope_theta=1e4)
    _close(got, want)


def test_port_init_draws_reference_scales():
    """The port's initialisers keep the reference's shapes, dtypes and
    scales (not its bits): per-leaf standard deviations agree."""
    gen = torch.Generator().manual_seed(0)
    spec = PL.AttnParamsSpec(256, 4, 2, 64)
    tp = spec.init(gen, torch.float32, leading=(3,), device="cpu")
    assert tuple(tp["wq"].shape) == (3, 256, 256)
    assert tuple(tp["wk"].shape) == (3, 256, 128)
    ref = RL.AttnParamsSpec(256, 4, 2, 64).init(jax.random.PRNGKey(0))
    for name in ("wq", "wk", "wv", "wo"):
        assert tp[name].dtype == torch.float32
        np.testing.assert_allclose(float(tp[name].std()),
                                   float(np.std(np.asarray(ref[name]))),
                                   rtol=0.05)
    m = PL.mlp_init(gen, 64, 256, "swiglu", torch.bfloat16, device="cpu")
    assert m["wo"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(m["wo"].float().std()), 1 / 16,
                               rtol=0.1)
