"""The port's MoE family against the reference, with the reference's
parameters carried across by ``params_from_reference``.

* ``layers.moe_block`` against the reference's ``layers.moe_block`` on
  reduced granite-moe-1b (4 experts, top-2) and a reduced moonshot-16b
  (16 experts, top-6, expert width 48), in float32 and bfloat16, dropless
  and with ``capacity_factor=1.25`` at a shape where tokens really are
  dropped; outputs and aux loss. A case where two routing probabilities
  tie exactly.
* The MoE LM's ``apply`` (with the aux loss), ``prefill`` (logits, K/V)
  and ``decode_step`` with a bf16 and an int8 KV cache, against the
  reference LM; the twin of ``tests/test_models_smoke.py``'s
  ``test_decode_matches_prefill`` for the MoE family; the bridge keeps the
  router leaves of a bfloat16 tree in float32.

Tolerances, relative to the largest reference value of each compared
tensor: float32 1e-4 (the frameworks sum in other orders); bfloat16 5e-2
(bf16 keeps ~3 significant digits and the two round at other places). The
LM comparisons run in float32: in bfloat16 the two frameworks' hidden
states differ in the last bits before a layer's router, and a routing
probability that sits within that of the k-th can send a token to another
expert, a gate's worth of difference that no tolerance describes. At the
block level both packages route the same input, so bfloat16 is compared
there.
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
from repro_torch.configs import get_arch, reduced
from repro_torch.core import lockcheck
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import LM, build_model
from repro_torch.models import layers as L

torch.set_num_threads(1)

RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (arch, overrides of the reduced config): granite as ``reduced`` makes it;
# moonshot with more experts than ``reduced`` keeps, so that top-6 of 16
# is exercised
ARCHS = {"granite-moe-1b-a400m": {},
         "moonshot-v1-16b-a3b": dict(n_experts=16, top_k=6, d_ff=48)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def configs(arch: str, dtype: str = "float32"):
    kw = dict(ARCHS[arch], dtype=dtype)
    return (dataclasses.replace(ref_reduced(ref_get_arch(arch)), **kw),
            dataclasses.replace(reduced(get_arch(arch)), **kw))


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * scale, (err, scale)


def _to_port(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def _block_inputs(cfg, dtype, shape, seed=0):
    rp = ref_layers.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff,
                             cfg.n_experts, jnp.dtype(dtype))
    x = jnp.asarray(np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)), dtype)
    return rp, x


def _dropped(rp, x, cfg, capacity_factor) -> int:
    """How many (token, k) pairs the reference's capacity drops, counted
    from its own routing in numpy."""
    xt = np.asarray(x, np.float32).reshape(-1, cfg.d_model)
    logits = xt @ np.asarray(rp["router"])
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(idx.ravel(), minlength=cfg.n_experts)
    T = xt.shape[0]
    C = max(1, int(capacity_factor * T * cfg.top_k / cfg.n_experts))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_moe_block_matches_reference(arch, dtype, capacity_factor):
    rcfg, cfg = configs(arch, dtype)
    rp, x = _block_inputs(rcfg, dtype, (2, 7))
    if capacity_factor is not None:
        assert _dropped(rp, x, rcfg, capacity_factor) > 0
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=capacity_factor)
    r_y, r_aux = ref_layers.moe_block(rp, x, **kw)
    pp = _to_port(rp)
    assert pp["router"].dtype == torch.float32
    y, aux = L.moe_block(pp, _to_port({"x": x})["x"], **kw)
    assert y.dtype == pp["wi_gate"].dtype
    _close(y, r_y, dtype)
    _close(aux, r_aux, "float32")


def test_moe_block_breaks_a_tie_towards_the_lower_expert():
    """Experts 1 and 2 have equal router columns, so their probabilities
    tie exactly at the top-2 boundary; jax.lax.top_k takes expert 1, and
    so must the port (experts 1 and 2 have different weights)."""
    rcfg, cfg = configs("granite-moe-1b-a400m")
    rp, _ = _block_inputs(rcfg, "float32", (1, 1))
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 0] = 1.0 / cfg.d_model
    router[:, 3] = -1.0 / cfg.d_model
    rp = dict(rp, router=jnp.asarray(router))
    x = jnp.asarray(np.abs(np.random.default_rng(3).normal(
        size=(2, 5, cfg.d_model))), jnp.float32)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=None)
    r_y, _ = ref_layers.moe_block(rp, x, **kw)
    pp = _to_port(rp)
    probs = torch.softmax(_to_port({"x": x})["x"].reshape(10, -1)
                          @ pp["router"], dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 2])        # an exact tie
    _, expert, *_ = L.moe_route(probs, cfg.top_k)
    assert (expert == torch.tensor([0, 1])).all()
    y, _ = L.moe_block(pp, _to_port({"x": x})["x"], **kw)
    _close(y, r_y, "float32")


# ----------------------------------------------------------------- the LM
_MODELS: dict = {}


def models(arch: str, kv: str = "bf16", capacity_factor=1.25):
    """(reference model, its params, port model, port params), float32."""
    key = (arch, kv, capacity_factor)
    if key not in _MODELS:
        rcfg, cfg = configs(arch)
        rm = ref_build_model(rcfg, kv_cache_dtype=kv,
                             moe_capacity_factor=capacity_factor)
        rp = rm.init(jax.random.PRNGKey(0))
        pm = build_model(cfg, kv_cache_dtype=kv,
                         moe_capacity_factor=capacity_factor, device="cpu")
        _MODELS[key] = (rm, rp, pm, _to_port(rp))
    return _MODELS[key]


def _tokens(rng, cfg, shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_apply_and_prefill(arch):
    rm, rp, pm, pp = models(arch)
    rng = np.random.default_rng(0)
    toks = _tokens(rng, pm.cfg, (3, 40))
    lens = np.array([40, 17, 1], np.int32)
    t = torch.from_numpy(toks).long()
    _close(pm.apply(pp, t), rm.apply(rp, jnp.asarray(toks)), "float32")
    _close(pm._aux, rm._aux, "float32")
    assert float(pm._aux) > 0
    r_logits, r_kv = rm.prefill(rp, jnp.asarray(toks), jnp.asarray(lens))
    logits, kv = pm.prefill(pp, t, torch.from_numpy(lens).long())
    _close(logits, r_logits, "float32")
    assert set(kv) == {"k", "v"}
    for name in kv:
        _close(kv[name], r_kv[name], "float32")


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_steps_ragged_with_active_mask(arch, kv):
    """Ragged prefill, then decode steps with per-row lengths and a
    changing ``active`` mask, on both packages: live rows' logits and the
    caches (int8: the scales, and the values within one unit)."""
    rm, rp, pm, pp = models(arch, kv)
    rng = np.random.default_rng(1)
    plens = np.array([5, 12, 9], np.int32)
    toks = _tokens(rng, pm.cfg, (3, 12))
    _, r_kv = rm.prefill(rp, jnp.asarray(toks), jnp.asarray(plens))
    _, p_kv = pm.prefill(pp, torch.from_numpy(toks).long(),
                         torch.from_numpy(plens).long())
    r_cache = rm.init_cache(3, 32)
    r_cache = {k: r_cache[k].at[:, :, :12].set(r_kv[k].astype(r_cache[k].dtype))
               for k in r_cache}
    cache = pm.init_cache(3, 32)
    for k, leaf in cache.items():
        leaf[:, :, :12].copy_(p_kv[k])
    lens = plens.copy()
    for step in range(4):
        active = np.array([True, step % 2 == 0, step != 1])
        tok = _tokens(rng, pm.cfg, (3, 1))
        r_logits, r_cache = rm.decode_step(rp, r_cache, jnp.asarray(tok),
                                           jnp.asarray(lens),
                                           jnp.asarray(active))
        logits, out = pm.decode_step(pp, cache, torch.from_numpy(tok).long(),
                                     torch.from_numpy(lens).long(),
                                     torch.from_numpy(active))
        assert out is cache
        _close(logits[torch.from_numpy(active)], np.asarray(r_logits)[active],
               "float32")
        for name, leaf in cache.items():
            if leaf.dtype == torch.int8:
                assert np.abs(leaf.numpy().astype(int) - np.asarray(
                    r_cache[name]).astype(int)).max() <= 1
            else:
                _close(leaf, r_cache[name], "float32")
        lens = lens + active


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_prefill(arch):
    """Step-by-step decode logits == teacher-forced full-sequence logits
    (dropless, so that both route every token)."""
    _, cfg = configs(arch)
    model = build_model(cfg, moe_capacity_factor=None, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 10
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full = model.apply(params, toks)
    cache = model.init_cache(B, 16)
    for t in range(S):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_bridge_keeps_router_leaves_f32_in_a_bf16_tree():
    rcfg, cfg = configs("moonshot-v1-16b-a3b", "bfloat16")
    rp = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    pp = _to_port(rp)
    moe = pp["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    for name in ("wi_gate", "wi_up", "wo"):
        assert moe[name].dtype == torch.bfloat16
    assert tuple(moe["wi_gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                           cfg.d_model, cfg.d_ff)
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        got = pp
        for k in path:
            got = got[k.key]
        want = np.asarray(leaf)
        assert got.dtype == (torch.float32 if want.dtype == np.float32
                             else torch.bfloat16)
        assert np.array_equal(got.float().numpy(), want.astype(np.float32))


def test_init_matches_the_reference_tree_and_param_count():
    """The port's LM.init draws the reference's tree (keys, shapes, dtypes;
    the router in f32) and the configs count the reference's parameters."""
    for arch in ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b"):
        assert get_arch(arch).param_count == ref_get_arch(arch).param_count
        rcfg, cfg = configs(arch, "bfloat16")
        rshapes = jax.eval_shape(ref_build_model(rcfg).init,
                                 jax.random.PRNGKey(0))
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(rshapes):
            got = params
            for k in path:
                got = got[k.key]
            assert tuple(got.shape) == leaf.shape
            assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype)
