"""The port's serving engine on the MoE family: twins of
``tests/test_torch_serve.py``'s ``test_ragged_batch_matches_oracle`` and
``test_reload_policy_order_independence``.

The port's :class:`Engine` runs on the CPU (``device="cpu"``) with the
reference's parameters (``params_from_reference``) on reduced
granite-moe-1b (4 experts, top-2) and a reduced moonshot-16b (16 experts,
top-6). Its greedy tokens must equal the reference's
:func:`repro.serve.naive_generate` exactly (float32): ragged batches with
inert padded rows, and offload with preemption forcing swaps under every
reload policy. Both packages run the MoE block dropless in ``prefill`` and
``decode_step``, so a token's experts do not depend on its batch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.serve import naive_generate as ref_naive_generate
from repro_torch.configs import get_arch, reduced
from repro_torch.core import lockcheck
from repro_torch.core.bridge import params_from_reference
from repro_torch.models import build_model
from repro_torch.serve import Engine, RELOAD_POLICY_NAMES, ServeConfig

torch.set_num_threads(1)

ARCHS = {"granite-moe-1b-a400m": {},
         "moonshot-v1-16b-a3b": dict(n_experts=16, top_k=6, d_ff=48)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


_LMS: dict = {}


def lms(arch: str):
    """(reference model, its params, port model, port params), float32."""
    if arch not in _LMS:
        over = ARCHS[arch]
        rm = ref_build_model(dataclasses.replace(
            ref_reduced(ref_get_arch(arch)), **over))
        rp = rm.init(jax.random.PRNGKey(0))
        pm = build_model(dataclasses.replace(reduced(get_arch(arch)), **over),
                         device="cpu")
        pp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        _LMS[arch] = (rm, rp, pm, pp)
    return _LMS[arch]


_ORACLE: dict = {}


def oracle(prompts, *, max_new, max_len, arch):
    """The reference's unbatched greedy tokens, request i as rid i."""
    rm, rp, _, _ = lms(arch)
    out = []
    for i, p in enumerate(prompts):
        key = (arch, tuple(p), max_new, max_len)
        if key not in _ORACLE:
            _ORACLE[key] = ref_naive_generate(rm, rp, p, max_new=max_new,
                                              max_len=max_len, rid=i)
        out.append(_ORACLE[key])
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ragged_batch_matches_oracle(arch):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11], [12, 13, 14, 15, 16]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2, 4), block_size=16)
    _, _, pm, pp = lms(arch)
    out = Engine(pm, pp, cfg).generate(prompts, max_new=6)
    assert out == oracle(prompts, max_new=6, max_len=64, arch=arch)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_reload_policy_order_independence(arch, policy):
    prompts = [list(range(1, 20)), list(range(5, 33)), [7, 8, 9, 10]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=8,
                      offload=True, hot_window=8, preempt_every=2,
                      reload_policy=policy, h2d_bw=300e6, d2h_bw=300e6)
    _, _, pm, pp = lms(arch)
    eng = Engine(pm, pp, cfg)
    out = eng.generate(prompts, max_new=6)
    assert out == oracle(prompts, max_new=6, max_len=64, arch=arch)
    st = eng.stats
    assert st.swaps >= 1 and st.offload_bytes > 0 and st.reload_bytes > 0
    assert eng.host.resident_bytes == 0
