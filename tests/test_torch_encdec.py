"""The port's encoder-decoder model (``repro_torch.models.encdec``) against
the reference's ``repro/models/encdec.py`` on reduced seamless-m4t-large-v2
(2 + 2 layers, d 128, 4 heads of 32, GELU with biases, layernorm), with the
reference's parameters carried across by ``params_from_reference``:
``encode``, ``decode``, ``apply`` and ``loss`` in float32 and bfloat16; a
12-step ``decode_step`` run against the reference's steps and against the
port's own teacher-forced ``decode``; ``init_cache``'s layout; the LoRA
loss gradient against ``jax.grad`` of the reference's ``make_lora_loss``
(which holds the cross-attention's dK and dV with Sq != Skv); the remat
modes; ``build_model``.

Tolerances, relative to the largest reference value of each compared
tensor: ``RTOL`` of ``tests/test_torch_lm.py`` (float32 1e-4: the two
frameworks sum in other orders; bfloat16 5e-2: ~3 significant digits,
rounded at other places, over 4 layers and 12 steps); gradients 1e-4 of
each leaf's largest reference value (float32).
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
from repro_torch.configs import get_arch, reduced
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import EncDec, LM, build_model
from repro_torch.models import lora, offload
from repro_torch.train import step
from repro_torch.train.tree import flatten

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
DTYPES = ["float32", "bfloat16"]
B, S_ENC, S_DEC, STEPS = 2, 12, 10, 12
_MODELS: dict = {}


def models(dtype: str, remat=None):
    """(reference model, its params, port model, port params)."""
    if dtype not in _MODELS:
        rcfg = dataclasses.replace(ref_reduced(ref_get_arch(ARCH)),
                                   dtype=dtype)
        rm = ref_build_model(rcfg)
        rp = rm.init(jax.random.PRNGKey(0))
        _MODELS[dtype] = (rm, rp, params_from_reference(
            jax.tree.map(np.asarray, rp), device="cpu"))
    rm, rp, pp = _MODELS[dtype]
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype=dtype)
    return rm, rp, build_model(cfg, device="cpu", remat=remat), pp


def inputs(vocab: int, seed: int = 0):
    """(frame embeddings [B, S_ENC, D] f32, tokens [B, S_DEC + 1] int32)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, S_ENC, 128)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, S_DEC + 1)).astype(np.int32)
    return emb, toks


def close(got: torch.Tensor, want, rtol: float) -> None:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    rm, rp, pm, pp = models(dtype)
    emb, _ = inputs(pm.cfg.vocab_size)
    with torch.no_grad():
        got = pm.encode(pp, emb)
    assert got.dtype == getattr(torch, dtype)
    close(got, rm.encode(rp, jnp.asarray(emb)), RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_reference(dtype):
    rm, rp, pm, pp = models(dtype)
    emb, toks = inputs(pm.cfg.vocab_size, seed=1)
    enc = rm.encode(rp, jnp.asarray(emb))
    want = rm.decode(rp, enc, jnp.asarray(toks))
    enc_t = torch.from_numpy(np.array(enc.astype(jnp.float32))).to(
        pm.dtype)
    with torch.no_grad():
        got = pm.decode(pp, enc_t, torch.as_tensor(toks))
    assert got.shape == (B, S_DEC + 1, pm.cfg.padded_vocab)
    close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_matches_reference(dtype):
    rm, rp, pm, pp = models(dtype)
    emb, toks = inputs(pm.cfg.vocab_size, seed=2)
    want = rm.apply(rp, jnp.asarray(toks), encoder_embeds=jnp.asarray(emb))
    with torch.no_grad():
        got = pm.apply(pp, torch.as_tensor(toks), encoder_embeds=emb)
    close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_matches_reference(dtype):
    rm, rp, pm, pp = models(dtype)
    emb, toks = inputs(pm.cfg.vocab_size, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "encoder_embeds": emb}
    want = float(rm.loss(rp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = pm.loss(pp, batch)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= RTOL[dtype] * abs(want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference_and_own_decode(dtype):
    """12 ``decode_step``s from an empty cache: each step's logits against
    the reference's step and against the port's teacher-forced ``decode``
    of the same tokens at that position. The port writes the cache in
    place; its K/V leaves end equal to the reference's."""
    rm, rp, pm, pp = models(dtype)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((B, S_ENC, 128)).astype(np.float32)
    toks = rng.integers(0, pm.cfg.vocab_size, (B, STEPS)).astype(np.int32)
    rcache = rm.init_cache(B, 16, S_ENC)
    rcache["enc_out"] = rm.encode(rp, jnp.asarray(emb))
    cache = pm.init_cache(B, 16, S_ENC)
    with torch.no_grad():
        cache["enc_out"].copy_(pm.encode(pp, emb))
        teacher = pm.decode(pp, cache["enc_out"], torch.as_tensor(toks))
        for t in range(STEPS):
            tok = toks[:, t:t + 1]
            want, rcache = rm.decode_step(rp, rcache, jnp.asarray(tok),
                                          jnp.int32(t))
            got, same = pm.decode_step(pp, cache, torch.as_tensor(tok), t)
            assert same is cache and got.shape == (B, pm.cfg.padded_vocab)
            close(got, want, RTOL[dtype])
            scale = float(teacher[:, t].float().abs().max())
            err = float((got.float() - teacher[:, t].float()).abs().max())
            assert err <= RTOL[dtype] * scale, (t, err, scale)
    close(cache["k"], rcache["k"], RTOL[dtype])
    close(cache["v"], rcache["v"], RTOL[dtype])


def test_init_cache_layout():
    rm, _, pm, _ = models("bfloat16")
    cfg = pm.cfg
    cache = pm.init_cache(3, 20, 7)
    want = rm.init_cache(3, 20, 7)
    assert sorted(cache) == sorted(want) == ["enc_out", "k", "v"]
    for k in want:
        assert tuple(cache[k].shape) == tuple(want[k].shape), k
        assert cache[k].dtype == torch.bfloat16
        assert not cache[k].any()
    assert tuple(cache["k"].shape) == (cfg.n_decoder_layers, 3, 20,
                                       cfg.n_kv_heads, cfg.d_head)


def _ref_adapters(rp, rank=4, seed=0):
    """The reference's adapters with B drawn nonzero (with B = 0 the
    gradient of A is 0)."""
    ad = ref_lora.lora_init(jax.random.PRNGKey(1), rp, rank=rank)
    rng = np.random.default_rng(seed)
    return {k: {"A": np.asarray(v["A"]),
                "B": 0.1 * rng.standard_normal(v["B"].shape).astype(
                    np.float32)} for k, v in ad.items()}


def test_lora_targets_the_enc_dec_tree():
    """``lora_init`` finds the reference's targets on the enc-dec tree:
    wq, wk, wv of the encoder's attention and of the decoder's self- and
    cross-attention, and the GELU up-projection wi."""
    _, rp, _, pp = models("float32")
    want = ref_lora.lora_init(jax.random.PRNGKey(1), rp, rank=8)
    got = lora.lora_init(torch.Generator().manual_seed(1), pp, rank=8)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(
        [f"enc_layers/attn/{w}" for w in ("wq", "wk", "wv")]
        + [f"dec_layers/{a}/{w}" for a in ("self_attn", "cross_attn")
           for w in ("wq", "wk", "wv")]
        + ["enc_layers/mlp/wi", "dec_layers/mlp/wi"])
    for k in want:
        assert tuple(got[k]["A"].shape) == tuple(want[k]["A"].shape), k
        assert tuple(got[k]["B"].shape) == tuple(want[k]["B"].shape), k


def test_lora_grads_match_reference():
    """The LoRA loss and every adapter gradient against
    ``jax.value_and_grad`` of the reference's ``make_lora_loss``, float32,
    each within 1e-4 of its own largest reference value: the
    cross-attention's dK and dV (Sq != Skv) reach the encoder's
    adapters."""
    rm, rp, pm, pp = models("float32")
    emb, toks = inputs(pm.cfg.vocab_size, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "encoder_embeds": emb}
    ad_np = _ref_adapters(rp)
    rloss, rg = jax.value_and_grad(ref_lora.make_lora_loss(rm, rp, rank=4))(
        jax.tree.map(jnp.asarray, ad_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ad = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
          for k, v in ad_np.items()}
    loss, g = step.value_and_grad(lora.make_lora_loss(pm, pp, rank=4), ad,
                                  batch)
    assert abs(loss.item() - float(rloss)) <= 1e-5 * abs(float(rloss))
    want = dict(flatten(jax.tree.map(np.asarray, rg)))
    got = dict(flatten(g))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert float(got[k].abs().max()) > 0, k
        err = float(np.abs(got[k].numpy() - w).max())
        scale = float(np.abs(w).max())
        assert err <= 1e-4 * scale, (k, err, scale)


@pytest.mark.parametrize("remat", ["full", "offload"])
def test_remat_modes_give_the_same_gradient(remat):
    """remat 'full' and 'offload' against None: the loss and every
    parameter's gradient bit for bit; 'offload' moves each layer's input
    out and back once (encoder and decoder)."""
    _, _, pm0, pp = models("float32")
    _, _, pm, _ = models("float32", remat=remat)
    emb, toks = inputs(pm.cfg.vocab_size, seed=6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "encoder_embeds": emb}
    l0, g0 = step.value_and_grad(pm0.loss, pp, batch)
    offload.reset_moved()
    l1, g1 = step.value_and_grad(pm.loss, pp, batch)
    assert torch.equal(l0, l1)
    for (k, a), (_, c) in zip(flatten(g0), flatten(g1)):
        assert torch.equal(a, c), k
    cfg = pm.cfg
    width = 4 * B * cfg.d_model
    want = (cfg.n_layers * S_ENC + cfg.n_decoder_layers * S_DEC) * width
    assert offload.moved == ({"offloaded": want, "reloaded": want}
                             if remat == "offload"
                             else {"offloaded": 0, "reloaded": 0})


def test_build_model_returns_encdec():
    cfg = reduced(get_arch(ARCH))
    m = build_model(cfg, device="cpu", remat="offload")
    assert isinstance(m, EncDec) and not isinstance(m, LM)
    assert (m.remat, m.device.type) == ("offload", "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    _, rp, _, _ = models("float32")
    want = dict(flatten(jax.tree.map(np.asarray, rp)))
    got = dict(flatten(p))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    with pytest.raises(ValueError):
        EncDec(reduced(get_arch("llama-7b")), device="cpu")
    with pytest.raises(TypeError):      # no option the kernel would ignore
        build_model(cfg, device="cpu", block_kv=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_model(cfg)            # the card unless asked for the CPU


def test_zero_stub_gradients_overflow_at_depth():
    """Why the launcher's stub frame embeddings are N(0, 1), not the
    reference's zeros: at the model's depth (24 + 24 layers, reduced
    width, float32) zero embeddings leave the encoder's residual stream
    at zero, where each layernorm's Jacobian is 1/sqrt(eps); the gradient
    overflows and the encoder's weight gradients are non-finite, in the
    reference's loss as in the port's. N(0, 1) embeddings give finite
    gradients."""
    from repro_torch.launch import train as T
    rcfg = dataclasses.replace(ref_reduced(ref_get_arch(ARCH)), n_layers=24,
                               n_decoder_layers=24)
    rm = ref_build_model(rcfg)
    rp = rm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), n_layers=24,
                              n_decoder_layers=24)
    pm = build_model(cfg, device="cpu")
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    _, toks = inputs(cfg.vocab_size, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    zeros = np.zeros((B, S_DEC, cfg.d_model), np.float32)
    _, rg = jax.value_and_grad(rm.loss)(rp, {**{k: jnp.asarray(v) for k, v
                                                in batch.items()},
                                            "encoder_embeds": zeros})
    bad = [k for k, v in flatten(jax.tree.map(np.asarray, rg))
           if not np.isfinite(v).all()]
    assert bad and all(k.startswith("enc_layers/") for k in bad), bad

    def port_bad(emb):
        _, g = step.value_and_grad(pm.loss, pp,
                                   {**batch, "encoder_embeds": emb})
        return [k for k, v in flatten(g) if not torch.isfinite(v).all()]
    assert sorted(port_bad(zeros)) == sorted(bad)
    args = T.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--batch", str(B), "--seq", str(S_DEC)])
    stub = T.setup(args).batch_fn(0)["encoder_embeds"]
    assert port_bad(stub.numpy()) == []
