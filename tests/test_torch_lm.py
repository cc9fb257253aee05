"""The port's dense LM against the reference's ``models/lm.py``, with the
reference's parameters carried across by ``params_from_reference``:
``apply`` logits, ``prefill`` last logits and K/V, and ``decode_step``
logits and cache over ragged steps with an ``active`` mask, for reduced
llama-7b (rmsnorm, GQA) and olmo-1b (non-parametric LayerNorm), in float32
and bfloat16; the int8 KV cache; inert rows that leave the cache
untouched (the port writes it in place).

Tolerances, relative to the largest reference value of each compared
tensor: float32 1e-4 (the frameworks sum in other orders, over 2 layers);
bfloat16 5e-2 (bf16 keeps ~3 significant digits and the two round at
other places, compounded over 2 layers and several decode steps).
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
from repro_torch.configs import get_arch, reduced
from repro_torch.core import lockcheck
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import LM, build_model

torch.set_num_threads(1)

RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["llama-7b", "olmo-1b"]


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


_MODELS: dict = {}


def models(arch: str, dtype: str, kv: str = "bf16"):
    """(reference model, its params, port model, port params)."""
    key = (arch, dtype, kv)
    if key not in _MODELS:
        rcfg = dataclasses.replace(ref_reduced(ref_get_arch(arch)),
                                   dtype=dtype)
        rm = ref_build_model(rcfg, kv_cache_dtype=kv)
        rp = rm.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(reduced(get_arch(arch)), dtype=dtype)
        pm = build_model(cfg, kv_cache_dtype=kv, device="cpu")
        pp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        _MODELS[key] = (rm, rp, pm, pp)
    return _MODELS[key]


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * scale, (err, scale)


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_prefill(arch, dtype):
    rm, rp, pm, pp = models(arch, dtype)
    rng = np.random.default_rng(0)
    toks = _tokens(rng, pm.cfg, (3, 40))
    lens = np.array([40, 17, 1], np.int32)
    t = torch.from_numpy(toks).long()
    _close(pm.apply(pp, t), rm.apply(rp, jnp.asarray(toks)), dtype)
    r_logits, r_kv = rm.prefill(rp, jnp.asarray(toks), jnp.asarray(lens))
    logits, kv = pm.prefill(pp, t, torch.from_numpy(lens).long())
    _close(logits, r_logits, dtype)
    assert set(kv) == {"k", "v"}
    for name in kv:
        assert kv[name].dtype == pm.dtype
        _close(kv[name], r_kv[name], dtype)


def _decode_run(rm, rp, pm, pp, *, steps, batch=3, max_len=32):
    """Prefill ragged rows, then decode ``steps`` steps on both packages
    with ragged lengths and a changing ``active`` mask. Yields each step's
    (port logits, reference logits, port cache, reference cache, active)."""
    rng = np.random.default_rng(1)
    plens = np.array([5, 12, 9][:batch], np.int32)
    toks = _tokens(rng, pm.cfg, (batch, int(plens.max())))
    _, r_kv = rm.prefill(rp, jnp.asarray(toks), jnp.asarray(plens))
    _, kv = pm.prefill(pp, torch.from_numpy(toks).long(),
                       torch.from_numpy(plens).long())
    S = toks.shape[1]
    r_cache = rm.init_cache(batch, max_len)
    r_cache = {k: r_cache[k].at[:, :, :S].set(r_kv[k].astype(r_cache[k].dtype))
               for k in r_cache}
    cache = pm.init_cache(batch, max_len)
    for k, leaf in cache.items():
        leaf[:, :, :S].copy_(kv[k])
    lens = plens.copy()
    for step in range(steps):
        active = np.array([True, step % 2 == 0, step != 1][:batch])
        tok = _tokens(rng, pm.cfg, (batch, 1))
        r_logits, r_cache = rm.decode_step(rp, r_cache, jnp.asarray(tok),
                                           jnp.asarray(lens),
                                           jnp.asarray(active))
        logits, out = pm.decode_step(pp, cache, torch.from_numpy(tok).long(),
                                     torch.from_numpy(lens).long(),
                                     torch.from_numpy(active))
        assert out is cache                      # updated in place
        yield logits, r_logits, cache, r_cache, active
        lens = lens + active


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_ragged_with_active_mask(arch, dtype):
    rm, rp, pm, pp = models(arch, dtype)
    for logits, r_logits, cache, r_cache, active in _decode_run(
            rm, rp, pm, pp, steps=4):
        # inert rows' logits are garbage by contract: compare live rows
        _close(logits[torch.from_numpy(active)], np.asarray(r_logits)[active],
               dtype)
        for name in ("k", "v"):
            _close(cache[name], r_cache[name], dtype)


def test_int8_kv_cache():
    rm, rp, pm, pp = models("llama-7b", "float32", kv="int8")
    rng = np.random.default_rng(2)
    toks = _tokens(rng, pm.cfg, (2, 24))
    lens = np.array([24, 10], np.int32)
    r_logits, r_kv = rm.prefill(rp, jnp.asarray(toks), jnp.asarray(lens))
    logits, kv = pm.prefill(pp, torch.from_numpy(toks).long(),
                            torch.from_numpy(lens).long())
    _close(logits, r_logits, "float32")
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
    for name in ("k_scale", "v_scale"):
        _close(kv[name], r_kv[name], "float32")
    for name in ("k", "v"):     # a rounding tie may flip one unit
        assert np.abs(kv[name].numpy().astype(int)
                      - np.asarray(r_kv[name]).astype(int)).max() <= 1
    for logits, r_logits, cache, r_cache, active in _decode_run(
            rm, rp, pm, pp, steps=3):
        _close(logits[torch.from_numpy(active)], np.asarray(r_logits)[active],
               "float32")
        for name in ("k_scale", "v_scale"):
            _close(cache[name], r_cache[name], "float32")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_inert_rows_leave_the_cache_untouched(kv):
    _, _, pm, pp = models("olmo-1b", "float32", kv=kv)
    gen = torch.Generator().manual_seed(3)
    cache = pm.init_cache(4, 16)
    for leaf in cache.values():
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in cache.items()}
    lens = torch.tensor([3, 7, 0, 15])
    active = torch.tensor([True, False, False, True])
    pm.decode_step(pp, cache, torch.tensor([[1], [2], [3], [4]]), lens, active)
    for name, leaf in cache.items():
        changed = (leaf != before[name]).reshape(leaf.shape[0], 4, 16, -1)
        where = changed.any(dim=(0, 3)).nonzero().tolist()
        # only the active rows, only at their own positions
        assert where and set(map(tuple, where)) <= {(0, 3), (3, 15)}, where


def test_init_draws_on_the_generator_and_port_defaults_to_cuda():
    cfg = reduced(get_arch("llama-7b"))
    m = LM(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(5))
    b = m.init(torch.Generator().manual_seed(5))
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert tuple(a["layers"]["attn"]["wq"].shape) == (2, 128, 128)
    assert tuple(a["layers"]["ln1_g"].shape) == (2, 128)
    assert a["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LM(cfg)                     # the card unless asked for the CPU
    with pytest.raises(ValueError):     # the enc-dec family is not ported
        LM(reduced(get_arch("seamless-m4t-large-v2")), device="cpu")
