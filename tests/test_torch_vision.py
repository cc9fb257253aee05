"""The vision frontend of the port's LM against the reference's
(``repro/models/lm.py:191-201``, ``:255-262``) on reduced internvl2-26b
(dense, rmsnorm, GQA 4 over 2, 8 frontend tokens), with the reference's
parameters carried across by ``params_from_reference``: ``apply`` with
``vision_embeds`` prepended (logits over every position) and ``loss``
(the frontend's positions take no loss), in float32 and bfloat16, at the
tolerances of ``tests/test_torch_lm.py`` (``RTOL`` x the largest
reference value); the frontend is refused by the recurrent families."""
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
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "internvl2-26b"
RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S = 2, 12


def models(dtype: str):
    rcfg = dataclasses.replace(ref_reduced(ref_get_arch(ARCH)), dtype=dtype)
    rm = ref_build_model(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype=dtype)
    pm = build_model(cfg, device="cpu")
    return rm, rp, pm, params_from_reference(jax.tree.map(np.asarray, rp),
                                             device="cpu")


def inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    ve = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)
                             ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return ve, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_loss_with_vision_embeds_match_reference(dtype):
    rm, rp, pm, pp = models(dtype)
    cfg = pm.cfg
    assert cfg.frontend == "vit" and cfg.family == "dense"
    ve, toks = inputs(cfg)
    want = np.asarray(rm.apply(rp, jnp.asarray(toks[:, :-1]),
                               vision_embeds=jnp.asarray(ve)
                               ).astype(jnp.float32))
    with torch.no_grad():
        got = pm.apply(pp, torch.as_tensor(toks[:, :-1]).long(),
                       vision_embeds=ve)
    assert got.shape == (B, cfg.n_frontend_tokens + S, cfg.padded_vocab)
    assert got.dtype == getattr(torch, dtype)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= RTOL[dtype] * float(np.abs(want).max())
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "vision_embeds": ve}
    rloss = float(rm.loss(rp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        loss = pm.loss(pp, batch)
    assert abs(loss.item() - rloss) <= RTOL[dtype] * abs(rloss)


def test_vision_embeds_change_the_text_logits():
    """The text positions see the prepended embeddings: their logits
    differ from ``apply`` without them."""
    _, _, pm, pp = models("float32")
    ve, toks = inputs(pm.cfg, seed=1)
    t = torch.as_tensor(toks[:, :-1]).long()
    with torch.no_grad():
        nf = pm.cfg.n_frontend_tokens
        with_v = pm.apply(pp, t, vision_embeds=ve)[:, nf:]
        without = pm.apply(pp, t)
    assert with_v.shape == without.shape
    assert not torch.allclose(with_v, without, atol=1e-3)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_families_refuse_a_frontend(arch):
    cfg = reduced(get_arch(arch))
    pm = build_model(cfg, device="cpu")
    pp = pm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frontend"):
        pm.apply(pp, torch.zeros((1, 4), dtype=torch.long),
                 vision_embeds=np.zeros((1, 2, cfg.d_model), np.float32))


def test_zero_stub_gradients_overflow_at_depth():
    """Why the launcher's stub vision embeddings are N(0, 1), not the
    reference's zeros: at internvl2-26b's depth (48 layers, reduced width,
    float32) zero embeddings keep the frontend's positions at zero, where
    each rmsnorm's Jacobian is 1/sqrt(eps); the gradient overflows along
    them and the weight gradients are non-finite, in the reference's loss
    as in the port's. N(0, 1) embeddings give finite gradients."""
    from repro_torch.launch import train as T
    from repro_torch.train import step
    from repro_torch.train.tree import flatten
    rcfg = dataclasses.replace(ref_reduced(ref_get_arch(ARCH)), n_layers=48)
    rm = ref_build_model(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), n_layers=48)
    pm = build_model(cfg, device="cpu")
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    _, toks = inputs(cfg, seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    zeros = np.zeros((B, cfg.n_frontend_tokens, cfg.d_model), np.float32)
    _, rg = jax.value_and_grad(rm.loss)(rp, {**{k: jnp.asarray(v) for k, v
                                                in batch.items()},
                                            "vision_embeds": zeros})
    bad = [k for k, v in flatten(jax.tree.map(np.asarray, rg))
           if not np.isfinite(v).all()]
    assert bad

    def port_bad(ve):
        _, g = step.value_and_grad(pm.loss, pp, {**batch, "vision_embeds": ve})
        return [k for k, v in flatten(g) if not torch.isfinite(v).all()]
    assert sorted(port_bad(zeros)) == sorted(bad)
    args = T.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--batch", str(B), "--seq", str(S)])
    stub = T.setup(args).batch_fn(0)["vision_embeds"]
    assert port_bad(stub.numpy()) == []
