"""The port's training stack against the reference's, on the CPU, with the
reference's parameters carried across (``params_from_reference``) and
float32 models:

* ``LM.loss`` and its gradient (every leaf) against
  ``jax.value_and_grad`` of the reference's ``LM.loss``, for each decoder
  family: dense with rmsnorm (llama-7b), dense with non-parametric
  LayerNorm (olmo-1b), MoE with its aux term (granite-moe-1b-a400m), rwkv
  (rwkv6-7b) and zamba (zamba2-7b), all reduced;
* every ``remat`` mode equal to ``remat=None``, bit for bit, and the
  ``'offload'`` mode's byte counts;
* ``AdamW`` and ``Lion`` on the same gradients; one ``make_train_step``
  step, and one with ``grad_accum=2``, against the reference's step;
* ``lora_init``'s keys and shapes, ``lora_apply``'s merged weights and
  ``make_lora_loss``'s gradients against the reference's.

Tolerance: |port - ref| <= atol + 1e-5 |ref| elementwise, atol the larger
of 1e-6 and 1e-5 of the compared tensor's largest |ref| (float32: the two
frameworks sum in other orders over 2 layers, and rwkv's WKV recurrence is
summed in chunks on one side and step by step on the other), unless a
test says otherwise.
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
from repro.models import lora as ref_lora
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.configs import get_arch, reduced
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import build_model
from repro_torch.models import lora as lora
from repro_torch.models import offload
from repro_torch.train import optim, step
from repro_torch.train.tree import flatten, unflatten

torch.set_num_threads(1)
FAMILIES = ["llama-7b", "olmo-1b", "granite-moe-1b-a400m", "rwkv6-7b",
            "zamba2-7b"]
_CACHE: dict = {}


def models(arch: str, remat=None):
    """(reference model, reference params, port model, port params)."""
    if arch not in _CACHE:
        rcfg = dataclasses.replace(ref_reduced(ref_get_arch(arch)),
                                   dtype="float32")
        rm = ref_build_model(rcfg)
        rp = rm.init(jax.random.PRNGKey(0))
        if rcfg.family == "rwkv":       # exercise the zero-initialised mixes
            rng = np.random.default_rng(5)
            rp = jax.tree_util.tree_map_with_path(
                lambda p, a: a + 0.1 * rng.standard_normal(a.shape).astype(
                    np.float32) if str(p[-1].key) in (
                        "mix_rkvwg", "cmix_k", "cmix_r", "mix_lora_B",
                        "w_lora_B") else a, rp)
        _CACHE[arch] = (rcfg, rm, rp,
                        params_from_reference(jax.tree.map(np.asarray, rp),
                                              device="cpu"))
    rcfg, rm, rp, pp = _CACHE[arch]
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    return rm, rp, build_model(cfg, device="cpu", remat=remat), pp


def batch(vocab: int, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def close(got, want, **tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    if not tol:
        tol = dict(rtol=1e-5, atol=max(1e-6, 1e-5 * float(
            np.abs(want).max(initial=0.0))))
    np.testing.assert_allclose(got, want, **tol)


def ref_grads(rm, rp, b):
    loss, g = jax.value_and_grad(rm.loss)(rp, {k: jnp.asarray(v)
                                               for k, v in b.items()})
    return float(loss), dict(flatten(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    rm, rp, pm, pp = models(arch)
    b = batch(pm.cfg.vocab_size)
    want_loss, want = ref_grads(rm, rp, b)
    loss, grads = step.value_and_grad(pm.loss, pp, b)
    close(loss.item(), want_loss)
    got = dict(flatten(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])
    if pm.cfg.family == "moe":
        assert float(pm._aux.detach()) > 0     # the aux term is in the loss


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("remat", ["full", "dots", "offload"])
def test_remat_modes_equal_no_remat(arch, remat):
    _, _, pm0, pp = models(arch)
    _, _, pm, _ = models(arch, remat=remat)
    b = batch(pm.cfg.vocab_size, seed=1)
    l0, g0 = step.value_and_grad(pm0.loss, pp, b)
    offload.reset_moved()
    l1, g1 = step.value_and_grad(pm.loss, pp, b)
    assert torch.equal(l0, l1)
    for (k, a), (_, c) in zip(flatten(g0), flatten(g1)):
        assert torch.equal(a, c), k
    if remat == "offload":
        B, S = b["tokens"].shape
        n = pm.cfg.n_layers
        width = 4 * B * S * pm.cfg.d_model
        assert offload.moved == {"offloaded": n * width,
                                 "reloaded": n * width}


def test_loss_masks_the_vocab_padding_and_refuses_a_frontend():
    cfg = dataclasses.replace(reduced(get_arch("llama-7b")), dtype="float32",
                              vocab_size=500)
    assert cfg.padded_vocab > cfg.vocab_size
    pm = build_model(cfg, device="cpu")
    pp = pm.init(torch.Generator().manual_seed(0))
    b = batch(cfg.vocab_size)
    with torch.no_grad():
        logits = pm.apply(pp, torch.as_tensor(b["tokens"]).long()).float()
        logp = torch.log_softmax(logits[..., :cfg.vocab_size], dim=-1)
        want = -logp.gather(-1, torch.as_tensor(b["labels"]).long()[..., None])
        torch.testing.assert_close(pm.loss(pp, b), want.mean())
    with pytest.raises(NotImplementedError, match="A12"):
        pm.loss(pp, {**b, "vision_embeds": np.zeros((2, 4, 8), np.float32)})


def _rand_tree(like: dict, seed: int) -> tuple[dict, dict]:
    """(numpy tree, torch tree) of random values shaped like ``like``."""
    rng = np.random.default_rng(seed)
    flat = [(k, rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in flatten(like)]
    np_tree = unflatten(like, [a for _, a in flat])
    return np_tree, unflatten(like, [torch.from_numpy(a.copy())
                                     for _, a in flat])


@pytest.mark.parametrize("name", ["AdamW", "Lion"])
def test_optimizers_match_reference(name):
    like = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(5)}}
    p_np, p_t = _rand_tree(like, 0)
    ref_opt = getattr(ref_optim, name)()
    opt = getattr(optim, name)()
    rs = ref_opt.init(jax.tree.map(jnp.asarray, p_np))
    st = opt.init(p_t)
    rp, pp = jax.tree.map(jnp.asarray, p_np), p_t
    for i in range(3):
        g_np, g_t = _rand_tree(like, 10 + i)
        ru, rs = ref_opt.update(jax.tree.map(jnp.asarray, g_np), rs, rp)
        u, st = opt.update(g_t, st, pp)
        rp = ref_optim.apply_updates(rp, ru)
        pp = optim.apply_updates(pp, u)
        for (k, a), (_, c) in zip(flatten(u), flatten(jax.tree.map(
                np.asarray, ru))):
            close(a, c, rtol=1e-5, atol=1e-9)
        assert int(st["count"]) == int(rs["count"]) == i + 1
        assert st["count"].dtype == torch.int32
    for (k, a), (_, c) in zip(flatten(pp), flatten(jax.tree.map(
            np.asarray, rp))):
        close(a, c, rtol=1e-6, atol=1e-7)
    for (k, a), (_, c) in zip(flatten(st["m"]), flatten(jax.tree.map(
            np.asarray, rs["m"]))):
        close(a, c)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(grad_accum):
    rm, rp, pm, pp = models("llama-7b")
    b = batch(pm.cfg.vocab_size, B=4, seed=2)
    rstate = {"params": rp, "opt": ref_optim.AdamW().init(rp),
              "step": jnp.zeros((), jnp.int32)}
    rnew, rmet = ref_step.make_train_step(rm, grad_accum=grad_accum)(
        rstate, {k: jnp.asarray(v) for k, v in b.items()})
    state = {"params": pp, "opt": optim.AdamW().init(pp),
             "step": torch.zeros((), dtype=torch.int32)}
    new, met = step.make_train_step(pm, grad_accum=grad_accum)(state, b)
    close(met["loss"].item(), float(rmet["loss"]))
    close(met["grad_norm"].item(), float(rmet["grad_norm"]))
    assert int(new["step"]) == 1 and new["step"].dtype == torch.int32
    # an AdamW step is lr·g/(|g| + eps) (+ decay): where |g| is a few eps
    # from zero, a difference of g in its last digits moves the step by a
    # share of lr, so the parameters are held to 1e-2 lr absolute
    want = dict(flatten(jax.tree.map(np.asarray, rnew)))
    for k, v in flatten(new):
        close(v, want[k], rtol=1e-5, atol=1e-2 * optim.AdamW().lr)
    # the state it started from is left as it was
    assert torch.equal(state["params"]["embed"], pp["embed"])


def test_init_train_state_and_microbatches():
    _, _, pm, _ = models("llama-7b")
    st = step.init_train_state(pm, torch.Generator().manual_seed(0))
    assert sorted(st) == ["opt", "params", "step"]
    assert sorted(st["opt"]) == ["count", "m", "v"]
    assert all(m.dtype == torch.float32 for m in flatten(st["opt"]["m"])
               for m in [m[1]])


def _ref_adapters(rp, rank=4, seed=0):
    """The reference's adapters with B drawn nonzero (with B = 0 the
    gradient of A is 0)."""
    ad = ref_lora.lora_init(jax.random.PRNGKey(1), rp, rank=rank)
    rng = np.random.default_rng(seed)
    return {k: {"A": np.asarray(v["A"]),
                "B": 0.1 * rng.standard_normal(v["B"].shape).astype(
                    np.float32)} for k, v in ad.items()}


@pytest.mark.parametrize("arch", ["llama-7b", "zamba2-7b", "rwkv6-7b"])
def test_lora_init_keys_and_shapes(arch):
    _, rp, _, pp = models(arch)
    want = ref_lora.lora_init(jax.random.PRNGKey(1), rp, rank=8)
    got = lora.lora_init(torch.Generator().manual_seed(1), pp, rank=8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]["A"].shape) == tuple(want[k]["A"].shape)
        assert tuple(got[k]["B"].shape) == tuple(want[k]["B"].shape)
        assert torch.count_nonzero(got[k]["B"]) == 0
        assert got[k]["A"].dtype == torch.float32
        d_in = got[k]["A"].shape[-1]
        assert abs(float(got[k]["A"].std()) * d_in ** 0.5 - 1) < 0.2


@pytest.mark.parametrize("arch", ["llama-7b", "granite-moe-1b-a400m",
                                  "zamba2-7b"])
def test_lora_merge_and_grads_match_reference(arch):
    rm, rp, pm, pp = models(arch)
    ad_np = _ref_adapters(rp)
    merged = ref_lora.lora_apply(rp, ad_np, rank=4)
    ad = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
          for k, v in ad_np.items()}
    eff = lora.lora_apply(pp, ad, rank=4)
    want_m = dict(flatten(jax.tree.map(np.asarray, merged)))
    for k, v in flatten(eff):
        full = v.full() if isinstance(v, lora.MergedStack) else v
        close(full, want_m[k])
    b = batch(pm.cfg.vocab_size, seed=3)
    rloss, rg = jax.value_and_grad(ref_lora.make_lora_loss(rm, rp, rank=4))(
        jax.tree.map(jnp.asarray, ad_np),
        {k: jnp.asarray(v) for k, v in b.items()})
    loss, g = step.value_and_grad(lora.make_lora_loss(pm, pp, rank=4), ad, b)
    close(loss.item(), float(rloss))
    want = dict(flatten(jax.tree.map(np.asarray, rg)))
    for k, v in flatten(g):
        assert float(v.abs().max()) > 0, k
        close(v, want[k])


def test_lora_stack_merges_one_layer_at_a_time():
    _, _, _, pp = models("llama-7b")
    ad = lora.lora_init(torch.Generator().manual_seed(0), pp, rank=4)
    eff = lora.lora_apply(pp, ad, rank=4)
    wq = eff["layers"]["attn"]["wq"]
    assert isinstance(wq, lora.MergedStack)
    assert wq.shape == pp["layers"]["attn"]["wq"].shape
    torch.testing.assert_close(wq[1], wq.full()[1])
    assert eff["layers"]["attn"]["wo"] is pp["layers"]["attn"]["wo"]
