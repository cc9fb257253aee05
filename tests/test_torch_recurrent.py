"""The port's recurrent families against the reference: the Mamba2 block
(``models/ssm.py``), the RWKV6 time and channel mixes (``models/rwkv.py``)
and the ``rwkv`` and ``zamba`` families of ``models/lm.py``, with the
reference's parameters carried across by ``params_from_reference`` and the
leaves the reference initialises to zero (the static mixes, the LoRAs' B
factors, ``bonus_u``, the channel-mix coefficients, ``conv_b``,
``dt_bias``) perturbed by seeded noise so that their paths are exercised.

Reduced rwkv6-7b (2 layers) and zamba2-7b (5 Mamba layers: 2 groups of 2
and a tail of 1, the shared block called twice); ``apply`` logits and a
10-step ``decode_step`` loop (logits and every cache leaf), the port's
decode against its own ``apply`` (the twin of
``tests/test_models_smoke.py::test_decode_matches_prefill``), the cache
layout, the refusals (``active``, ``prefill``, the ``Engine``), and the
flash kernel's plain version at zamba2-7b's head size 112 against the
reference's ``layers.blockwise_attention``.

Tolerances. float32: rtol = atol = 2e-4, elementwise (the frameworks sum in
other orders). bfloat16, relative to the largest reference value of the
compared tensor (``BLOCK_RTOL``, ``BF16_RTOL``): 3e-2 for one block, and
3e-2 for each family's ``apply`` and for rwkv6-7b's whole decode loop.
zamba2-7b's decode loop is held at 4e-2 for its logits and bf16 cache
leaves and 1e-1 for its f32 SSM states. The largest ratios measured on the
CPU: blocks 7.9e-3; rwkv6-7b apply 1.76e-2, decode logits 2.33e-2, WKV
state 1.27e-2; zamba2-7b apply 2.74e-2, decode logits 3.23e-2, conv and K/V
leaves 2.54e-2, SSM states 7.49e-2 (the tail's, at step 10). bf16 keeps ~3
significant digits, and the frameworks round at other places (the
reference's rmsnorm rounds its scale to bf16 before the product, the port's
kernel rounds once); the SSM state sums dt x B over the steps, so it
integrates those differences from every layer below it. That this is the
format's own error, not the port's, is a test of its own
(``test_bf16_decode_error_is_the_formats_own``): the reference's bf16
decode differs from its own float32 decode on the same weights by as much
(zamba2-7b: logits 3.95e-2, tail state 5.54e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_arch, reduced
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor, params_from_reference
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.models import build_model, rwkv, ssm
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ARCHS = ["rwkv6-7b", "zamba2-7b"]
BLOCK_RTOL = 3e-2
# per family: apply's logits; the decode loop's logits and bf16 cache
# leaves; its f32 recurrent states (see the module docstring)
BF16_RTOL = {"rwkv6-7b": dict(apply=3e-2, decode=3e-2, state=3e-2),
             "zamba2-7b": dict(apply=3e-2, decode=4e-2, state=1e-1)}
# the port's bf16 decode may differ from the reference's by at most this
# multiple of the reference's own bf16-vs-float32 difference
FORMAT_ERROR_FACTOR = 2.0


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _perturb_zero_leaves(params, seed: int = 0):
    """The reference's pytree with each all-zero float leaf replaced by
    0.1 * N(0, 1) noise (numpy seed), in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            if not np.asarray(a, np.float32).any():
                noise = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
                return jnp.asarray(noise).astype(a.dtype)
        return jnp.asarray(a)
    return jax.tree.map(leaf, params)


_MODELS: dict = {}


def models(arch: str, dtype: str):
    """(reference model, its perturbed params, port model, port params)."""
    key = (arch, dtype)
    if key not in _MODELS:
        rcfg = dataclasses.replace(ref_reduced(ref_get_arch(arch)),
                                   dtype=dtype)
        rm = ref_build_model(rcfg)
        rp = _perturb_zero_leaves(rm.init(jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(reduced(get_arch(arch)), dtype=dtype)
        pm = build_model(cfg, device="cpu")
        pp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        _MODELS[key] = (rm, rp, pm, pp)
    return _MODELS[key]


def _port(a) -> torch.Tensor:
    return host_tensor(np.asarray(a), pin=False)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _close(got: torch.Tensor, want, dtype: str, rtol=BLOCK_RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        return
    err = _rel_err(got, want)
    assert err <= rtol, (err, rtol)


def _layer(tree, *idx):
    return jax.tree.map(lambda a: a[idx], tree)


def _x(dtype, shape=(2, 40, 128), seed=1):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape), dtype)
    return x, _port(x)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_block_matches_reference(dtype, with_state):
    rm, rp, pm, pp = models("zamba2-7b", dtype)
    cfg = pm.cfg
    kw = dict(d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
              expand=cfg.ssm_expand)
    rlp = _layer(rp["mamba"], 1, 0)
    plp = {k: v[1, 0] for k, v in pp["mamba"].items()}
    if not with_state:
        x, tx = _x(dtype)
        _close(ssm.ssd_block(plp, tx, **kw), ref_ssm.ssd_block(rlp, x, **kw),
               dtype)
        return
    x, tx = _x(dtype, (2, 1, 128))          # one decode token
    rng = np.random.default_rng(2)
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_headdim
    st = rng.normal(size=(2, H, cfg.ssm_headdim, cfg.ssm_state))
    cs = jnp.asarray(rng.normal(size=(2, 3, di + 2 * cfg.ssm_state)), dtype)
    r_out, (r_st, r_cs) = ref_ssm.ssd_block(
        rlp, x, state=jnp.asarray(st, "float32"), conv_state=cs, **kw)
    out, (p_st, p_cs) = ssm.ssd_block(
        plp, tx, state=torch.from_numpy(st).float(), conv_state=_port(cs),
        **kw)
    _close(out, r_out, dtype)
    _close(p_st, r_st, dtype)
    assert p_st.dtype == torch.float32 and p_cs.dtype == pm.dtype
    _close(p_cs, r_cs, dtype)                   # the window, shifted
    assert torch.equal(p_cs[:, :2], _port(cs)[:, 1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_time_mix_matches_reference(dtype, with_state):
    rm, rp, pm, pp = models("rwkv6-7b", dtype)
    P = pm.cfg.rwkv_headdim
    rlp = _layer(rp["layers"], 1)
    plp = {k: v[1] for k, v in pp["layers"].items()}
    if not with_state:
        x, tx = _x(dtype)
        _close(rwkv.rwkv6_time_mix(plp, tx, headdim=P),
               ref_rwkv.rwkv6_time_mix(rlp, x, headdim=P), dtype)
        return
    x, tx = _x(dtype, (2, 3, 128))
    rng = np.random.default_rng(3)
    shift = jnp.asarray(rng.normal(size=(2, 1, 128)), dtype)
    wkv = rng.normal(size=(2, 128 // P, P, P)).astype(np.float32)
    r_out, (r_shift, r_wkv) = ref_rwkv.rwkv6_time_mix(
        rlp, x, headdim=P, state=(shift, jnp.asarray(wkv)))
    out, (p_shift, p_wkv) = rwkv.rwkv6_time_mix(
        plp, tx, headdim=P, state=(_port(shift), torch.from_numpy(wkv)))
    _close(out, r_out, dtype)
    _close(p_wkv, r_wkv, dtype)
    assert torch.equal(p_shift, tx[:, -1:])
    assert p_wkv.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_reference(dtype, with_state):
    rm, rp, pm, pp = models("rwkv6-7b", dtype)
    rlp = _layer(rp["layers"], 0)
    plp = {k: v[0] for k, v in pp["layers"].items()}
    x, tx = _x(dtype)
    if not with_state:
        _close(rwkv.rwkv6_channel_mix(plp, tx),
               ref_rwkv.rwkv6_channel_mix(rlp, x), dtype)
        return
    shift = jnp.asarray(np.random.default_rng(4).normal(size=(2, 1, 128)),
                        dtype)
    r_out, r_shift = ref_rwkv.rwkv6_channel_mix(rlp, x, state=shift)
    out, p_shift = rwkv.rwkv6_channel_mix(plp, tx, state=_port(shift))
    _close(out, r_out, dtype)
    assert torch.equal(p_shift, tx[:, -1:])


# ------------------------------------------------------------------- model
def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(arch, dtype):
    rm, rp, pm, pp = models(arch, dtype)
    toks = _tokens(pm.cfg, (2, 40))
    logits = pm.apply(pp, torch.from_numpy(toks).long())
    assert logits.dtype == pm.dtype
    _close(logits, rm.apply(rp, jnp.asarray(toks)), dtype,
           BF16_RTOL[arch]["apply"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(arch, dtype):
    """10 one-token steps from ``init_cache(2, 16)``: logits and every cache
    leaf after each step; the port's cache is written in place."""
    rm, rp, pm, pp = models(arch, dtype)
    toks = _tokens(pm.cfg, (2, 10), seed=1)
    r_cache = rm.init_cache(2, 16)
    cache = pm.init_cache(2, 16)
    step = jax.jit(rm.decode_step)
    for t in range(10):
        r_logits, r_cache = step(rp, r_cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(t, "int32"))
        logits, out = pm.decode_step(
            pp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        assert out is cache
        tol = BF16_RTOL[arch]
        _close(logits, r_logits, dtype, tol["decode"])
        for name, leaf in cache.items():
            recurrent = leaf.dtype == torch.float32 != pm.dtype
            _close(leaf, r_cache[name], dtype,
                   tol["state"] if recurrent else tol["decode"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_error_is_the_formats_own(arch):
    """Over 10 bf16 decode steps, the port's logits and each cache leaf
    differ from the reference's by at most FORMAT_ERROR_FACTOR times the
    reference's own bf16-vs-float32 difference (its float32 model on the
    same, bf16-valued weights), worst step against worst step."""
    rm, rp, pm, pp = models(arch, "bfloat16")
    rcfg = dataclasses.replace(ref_reduced(ref_get_arch(arch)),
                               dtype="float32")
    rm32 = ref_build_model(rcfg)
    rp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), rp)
    toks = _tokens(pm.cfg, (2, 10), seed=1)
    r_cache, r_cache32 = rm.init_cache(2, 16), rm32.init_cache(2, 16)
    cache = pm.init_cache(2, 16)
    step, step32 = jax.jit(rm.decode_step), jax.jit(rm32.decode_step)
    port_err: dict[str, float] = {}
    fmt_err: dict[str, float] = {}
    for t in range(10):
        tok, pos = jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, "int32")
        r_logits, r_cache = step(rp, r_cache, tok, pos)
        r_logits32, r_cache32 = step32(rp32, r_cache32, tok, pos)
        logits, cache = pm.decode_step(
            pp, cache, torch.from_numpy(toks[:, t:t + 1]).long(), t)
        for name, got, want, want32 in (
                [("logits", logits, r_logits, r_logits32)]
                + [(n, cache[n], r_cache[n], r_cache32[n]) for n in cache]):
            got = got.float().numpy()
            port_err[name] = max(port_err.get(name, 0.0),
                                 _rel_err(got, want))
            fmt_err[name] = max(fmt_err.get(name, 0.0),
                                _rel_err(want, want32))
    for name in port_err:
        assert port_err[name] <= FORMAT_ERROR_FACTOR * fmt_err[name], \
            (name, port_err[name], fmt_err[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_apply(arch):
    """Step-by-step decode logits == the full-sequence logits (float32),
    as ``tests/test_models_smoke.py`` holds the reference; the sequence
    forward runs the scan kernels' wrappers, the decode the models' own
    recurrences."""
    _, _, pm, pp = models(arch, "float32")
    toks = torch.from_numpy(_tokens(pm.cfg, (2, 10), seed=2)).long()
    full = pm.apply(pp, toks)
    cache = pm.init_cache(2, 16)
    for t in range(10):
        logits, cache = pm.decode_step(pp, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_cache_have_the_reference_layout(arch, dtype):
    rm, rp, pm, pp = models(arch, dtype)
    mine = pm.init(torch.Generator().manual_seed(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(rp)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert {jax.tree_util.keystr(k) for k in got} == \
        {jax.tree_util.keystr(k) for k in flat}
    want = {jax.tree_util.keystr(k): v for k, v in flat.items()}
    for k, v in got.items():
        ref = want[jax.tree_util.keystr(k)]
        assert tuple(v.shape) == tuple(ref.shape), k
        assert str(v.dtype).removeprefix("torch.") == str(ref.dtype), k
    r_cache = rm.init_cache(3, 24)
    cache = pm.init_cache(3, 24)
    assert set(cache) == set(r_cache)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == tuple(r_cache[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(r_cache[name].dtype), name
        assert not leaf.any()


def test_params_from_reference_carries_the_nested_zamba_tree():
    """[ng, grp, ...] Mamba leaves, the tail, the shared block and its
    adapters; bf16 leaves beside f32 ones (A_log, D, dt_bias), bit for
    bit."""
    _, rp, _, pp = models("zamba2-7b", "bfloat16")
    assert set(pp) == set(rp)
    assert set(pp["mamba"]) == set(rp["mamba"])
    n = 0
    for path, a in jax.tree_util.tree_flatten_with_path(rp)[0]:
        t = pp
        for k in path:
            t = t[k.key]
        a = np.asarray(a)
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, path
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), a), path
        n += 1
    assert pp["mamba"]["A_log"].dtype == torch.float32
    assert pp["mamba"]["in_proj"].dtype == torch.bfloat16
    assert tuple(pp["mamba"]["in_proj"].shape[:2]) == (2, 2)
    assert tuple(pp["mamba_tail"]["in_proj"].shape[:1]) == (1,)
    assert n == len(jax.tree.leaves(rp))


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_refuse_active_prefill_and_the_engine(arch):
    _, _, pm, pp = models(arch, "float32")
    cache = pm.init_cache(2, 8)
    tok = torch.zeros(2, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="active-row masking"):
        pm.decode_step(pp, cache, tok, 0, torch.tensor([True, False]))
    with pytest.raises(ValueError, match="attention families only"):
        pm.prefill(pp, tok, torch.tensor([1, 1]))
    with pytest.raises(ValueError, match="KV-cache family"):
        Engine(pm, pp, ServeConfig())


# --------------------------------------------------------- flash at Dh 112
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_head_size_112_matches_reference(dtype, causal):
    """zamba2-7b's shared block: 3584 / 32 heads = 112 channels a head."""
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 70, 4, 112)), dtype)
               for _ in range(3))
    ref = ref_layers.blockwise_attention(q, k, v, causal=causal, block_kv=32)
    got = flash_attention_plain(_port(q), _port(k), _port(v), causal=causal)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
