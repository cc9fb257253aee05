"""Twins of ``tests/test_serving.py`` for the port's serving engine.

The port's :class:`Engine` runs on the CPU (``device="cpu"``) with the
reference's parameters (``params_from_reference``), and every engine
configuration must give the reference's :func:`repro.serve.naive_generate`
tokens exactly (greedy, float32): ragged batches, inert padded rows,
window-edge prompts, a queue larger than the biggest bucket, offload with
preemption under every reload policy, double preemption, the tiered disk
tier, prefetch and the pooled engine. At temperature > 0 the port has its
own (seed, rid, position) schedule, so there the engine must equal the
port's own ``naive_generate``, whatever the batching. The models are
reduced olmo-1b (as the reference's tests use) and reduced llama-7b.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.serve import naive_generate as ref_naive_generate
from repro_torch.configs import get_arch, reduced
from repro_torch.core import (BuildConfig, HostPool, TaskGraph, TensorSpec,
                              build_memgraph, lockcheck)
from repro_torch.core.bridge import params_from_reference
from repro_torch.core.dispatch import D2H
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.models import build_model
from repro_torch.serve import (Engine, PagedKVCache, RELOAD_POLICY_NAMES,
                               ServeConfig, naive_generate)
from repro_torch.serve.engine import _Transfer, get_reload_policy

from helpers import fig3_taskgraph, int_inputs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


_LMS: dict = {}


def lms(arch: str = "olmo-1b"):
    """(reference model, its params, port model, port params), float32."""
    if arch not in _LMS:
        rm = ref_build_model(ref_reduced(ref_get_arch(arch)))
        rp = rm.init(jax.random.PRNGKey(0))
        pm = build_model(reduced(get_arch(arch)), device="cpu")
        pp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        _LMS[arch] = (rm, rp, pm, pp)
    return _LMS[arch]


_ORACLE: dict = {}


def oracle(prompts, *, max_new, max_len, arch="olmo-1b"):
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


def engine(cfg: ServeConfig, arch: str = "olmo-1b", **kw) -> Engine:
    _, _, pm, pp = lms(arch)
    return Engine(pm, pp, cfg, **kw)


# ------------------------------------------------------------------ basics
@pytest.mark.parametrize("arch", ["olmo-1b", "llama-7b"])
def test_ragged_batch_matches_oracle(arch):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11], [12, 13, 14, 15, 16]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2, 4), block_size=16)
    out = engine(cfg, arch).generate(prompts, max_new=6)
    assert out == oracle(prompts, max_new=6, max_len=64, arch=arch)


def test_padded_rows_inert():
    cfg = ServeConfig(max_len=64, batch_buckets=(4,), block_size=16)
    out = engine(cfg).generate([[1, 2, 3]], max_new=5)
    solo = ServeConfig(max_len=64, batch_buckets=(1,), block_size=16)
    assert out == engine(solo).generate([[1, 2, 3]], max_new=5)
    assert out == oracle([[1, 2, 3]], max_new=5, max_len=64)


def test_prompt_exactly_fills_window():
    cfg = ServeConfig(max_len=32, batch_buckets=(1, 2), block_size=8)
    prompts = [list(range(1, 33)), [5, 6, 7]]
    out = engine(cfg).generate(prompts, max_new=4)
    assert len(out[0]) == 1                     # window full after prefill
    assert len(out[1]) == 4
    assert out == oracle(prompts, max_new=4, max_len=32)


def test_prompt_near_window_truncates():
    cfg = ServeConfig(max_len=32, batch_buckets=(1,), block_size=8)
    out = engine(cfg).generate([list(range(1, 31))], max_new=10)
    assert len(out[0]) == 3                     # 32 - 30 + 1
    assert out == oracle([list(range(1, 31))], max_new=10, max_len=32)


def test_queue_exceeds_largest_bucket():
    prompts = [[i + 1, i + 2, i + 3, i + 4] for i in range(6)]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=16)
    eng = engine(cfg)
    out = eng.generate(prompts, max_new=4)
    assert out == oracle(prompts, max_new=4, max_len=64)
    assert eng.stats.tokens == 24
    for rid in range(len(prompts)):
        eng.release(rid)
    assert not eng.reqs and not eng._block_seq


def test_temperature_matches_port_oracle_whatever_the_batching():
    _, _, pm, pp = lms()
    prompts = [[1, 2, 3], [9, 8, 7, 6], [5]]
    want = [naive_generate(pm, pp, p, max_new=6, max_len=64, rid=i, seed=11,
                           temperature=0.7) for i, p in enumerate(prompts)]
    for buckets in ((1, 2, 4), (1,)):
        cfg = ServeConfig(max_len=64, batch_buckets=buckets, block_size=16,
                          temperature=0.7)
        assert engine(cfg).generate(prompts, max_new=6, seed=11) == want
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2, 4), block_size=16,
                      temperature=0.7)
    assert engine(cfg).generate(prompts, max_new=6, seed=12) != want
    greedy = [naive_generate(pm, pp, p, max_new=6, max_len=64, rid=i)
              for i, p in enumerate(prompts)]
    assert want != greedy                       # the draw is really random


def test_bad_requests_rejected():
    eng = engine(ServeConfig(max_len=32, block_size=8))
    with pytest.raises(ValueError):
        eng.submit([], 4)
    with pytest.raises(ValueError):
        eng.submit(list(range(40)), 4)
    with pytest.raises(ValueError):
        eng.submit([1, 2], 0)


def _recurrent_model():
    """A model whose family keeps no KV cache: reduced rwkv6-7b."""
    return build_model(reduced(get_arch("rwkv6-7b")), device="cpu")


def test_recurrent_families_rejected():
    with pytest.raises(ValueError):
        Engine(_recurrent_model(), {}, ServeConfig())


# ----------------------------------------------------------------- offload
@pytest.mark.parametrize("arch", ["olmo-1b", "llama-7b"])
def test_offload_smoke_two_requests(arch):
    prompts = [list(range(1, 25)), list(range(30, 48))]
    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, offload_fraction=1.0,
                      preempt_every=3, h2d_bw=500e6, d2h_bw=500e6)
    eng = engine(cfg, arch)
    out = eng.generate(prompts, max_new=8)
    assert out == oracle(prompts, max_new=8, max_len=64, arch=arch)
    st = eng.stats
    assert st.offload_bytes > 0 and st.reload_bytes > 0
    assert st.offloaded_fraction >= 0.5
    assert st.swaps >= 1
    assert eng.host.resident_bytes == 0


@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_reload_policy_order_independence(policy):
    prompts = [list(range(1, 20)), list(range(5, 33)), [7, 8, 9, 10]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=8,
                      offload=True, hot_window=8, preempt_every=2,
                      reload_policy=policy, h2d_bw=300e6, d2h_bw=300e6)
    out = engine(cfg).generate(prompts, max_new=6)
    assert out == oracle(prompts, max_new=6, max_len=64)


def test_mirrored_cold_blocks_survive_double_preempt():
    prompts = [list(range(1, 30)), list(range(2, 28)), list(range(3, 31))]
    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, preempt_every=2,
                      h2d_bw=500e6, d2h_bw=500e6)
    eng = engine(cfg)
    out = eng.generate(prompts, max_new=8)
    assert out == oracle(prompts, max_new=8, max_len=64)
    assert eng.stats.swaps >= 6                  # every request swapped twice


def test_stale_transfer_after_release_is_safe():
    eng = engine(ServeConfig(max_len=32, block_size=8))
    rid = eng.submit([1, 2, 3], 2)
    eng.run()
    eng.release(rid)
    stale = _Transfer(D2H, rid, 0, seq=0, nbytes=64)
    eng._service_d2h(stale)                      # must not raise
    pol = get_reload_policy("critical-path")
    pol.prepare(eng)
    assert pol.priority(stale) < 0               # drains stale items first


def test_dma_thread_error_surfaces_in_the_run_loop(monkeypatch):
    """A copy that fails on a DMA thread is raised by ``run`` (not a
    silently dead stream that wedges the engine), and no thread leaks."""
    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, preempt_every=3)
    eng = engine(cfg)

    def broken(src, written):
        raise OSError("copy engine fault")
    monkeypatch.setattr(eng, "_copy_to_host", broken)
    n_threads = threading.active_count()
    with pytest.raises(OSError, match="copy engine fault"):
        eng.generate([list(range(1, 25)), list(range(30, 48))], max_new=8)
    assert threading.active_count() == n_threads


# -------------------------------------------------------------- disk tier
@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_tiered_kv_matches_oracle_every_policy(policy):
    prompts = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9, 10, 11]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, offload_fraction=1.0,
                      preempt_every=3, reload_policy=policy,
                      h2d_bw=500e6, d2h_bw=500e6,
                      host_kv_bytes=1, disk_bw=300e6)  # everything spills
    with engine(cfg) as eng:
        out = eng.generate(prompts, max_new=8)
        assert out == oracle(prompts, max_new=8, max_len=64)
        st = eng.stats
        assert st.disk_spill_bytes > 0 and st.disk_load_bytes > 0
        assert st.swaps >= 1
        assert eng.host.resident_bytes == 0
        assert eng.host.disk.resident_bytes == 0


def test_swapped_queue_prefetch_fires_and_stays_oracle_exact():
    _, _, pm, _ = lms()
    prompts = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9, 10, 11]]
    want = oracle(prompts, max_new=8, max_len=64)
    blk = PagedKVCache(pm, 1, 64, block_size=8).block_nbytes

    def run(prefetch):
        cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                          offload=True, hot_window=0, offload_fraction=1.0,
                          preempt_every=3, h2d_bw=500e6, d2h_bw=500e6,
                          disk_bw=300e6, host_kv_bytes=3 * blk,
                          prefetch_swapped=prefetch)
        with engine(cfg) as eng:
            return eng.generate(prompts, max_new=8), eng.stats

    out_on, st_on = run(True)
    out_off, st_off = run(False)
    assert out_on == want and out_off == want
    assert st_on.disk_spill_bytes > 0
    assert st_on.prefetch_bytes > 0
    assert st_off.prefetch_bytes == 0


def test_tiered_kv_roomy_host_never_touches_disk():
    prompts = [list(range(1, 20)), [4, 5, 6]]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=8,
                      offload=True, hot_window=0, preempt_every=2,
                      h2d_bw=500e6, d2h_bw=500e6, host_kv_bytes=1 << 30)
    with engine(cfg) as eng:
        out = eng.generate(prompts, max_new=6)
        assert out == oracle(prompts, max_new=6, max_len=64)
        assert eng.stats.disk_spill_bytes == 0
        assert eng.stats.disk_load_bytes == 0


# ------------------------------------------------------------ shared pool
@pytest.mark.parametrize("arb", ("static", "demand", "priority"))
def test_pooled_engine_matches_oracle_and_bounds_pool(arb):
    _, _, pm, _ = lms()
    prompts = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9, 10, 11]]
    want = oracle(prompts, max_new=8, max_len=64)
    blk = PagedKVCache(pm, 1, 64, block_size=8).block_nbytes
    pool = HostPool((6 if arb == "priority" else 8) * blk, policy=arb)
    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, offload_fraction=1.0,
                      preempt_every=3, h2d_bw=500e6, d2h_bw=500e6,
                      disk_bw=300e6)
    with engine(cfg, pool=pool) as eng:
        out = eng.generate(prompts, max_new=8)
        assert out == want
        snap = pool.snapshot()
        assert 0 < snap["peak_bytes"] <= snap["capacity"]
        assert eng.host.resident_bytes == 0
        assert eng.host.disk.resident_bytes == 0
        for name in ("kv", "prefetch"):
            assert snap["leases"][name]["used"] == 0
        if arb == "priority":
            assert eng.stats.disk_spill_bytes > 0
            assert eng.stats.lease_deferrals > 0


def test_pooled_engine_drains_leases_of_abandoned_mirrors():
    """Every request finishes while its eager mirrors still wait in the
    slowed d2h queue; the run's shutdown abandons them, and their pool
    reservations must be given back all the same."""
    _, _, pm, _ = lms()
    prompts = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9, 10, 11]]
    want = oracle(prompts, max_new=8, max_len=64)
    blk = PagedKVCache(pm, 1, 64, block_size=8).block_nbytes
    pool = HostPool(64 * blk, policy="static")
    cfg = ServeConfig(max_len=64, batch_buckets=(4,), block_size=8,
                      offload=True, hot_window=0)
    with engine(cfg, pool=pool) as eng:
        real = eng._service_d2h

        def slow(tr):
            threading.Event().wait(0.2)
            real(tr)
        eng._service_d2h = slow
        assert eng.generate(prompts, max_new=8) == want
        assert eng.stats.offload_bytes < 9 * blk      # mirrors were dropped
        for name in ("kv", "prefetch"):
            assert pool.snapshot()["leases"][name]["used"] == 0


def _to_port(ref_tg) -> TaskGraph:
    tg = TaskGraph()
    for tid in sorted(ref_tg.vertices):
        v = ref_tg.vertices[tid]
        tg.add(v.kind.value, v.device, v.inputs,
               TensorSpec(v.out.shape, v.out.dtype), op=v.op,
               params=dict(v.params), flops=v.flops, name=v.name,
               streaming=v.streaming)
    return tg


def test_runtime_and_serving_share_one_arbitrated_pool():
    """A MEMGRAPH plan's offloads and the engine's KV mirror run
    concurrently against one HostPool: both stay exact, the bound holds."""
    _, _, pm, _ = lms()
    ref_tg = fig3_taskgraph()
    tg = _to_port(ref_tg)
    inputs = int_inputs(ref_tg)
    want_rt = eval_taskgraph(tg, inputs, device="cpu")
    res = build_memgraph(tg, BuildConfig(capacity=3, host_capacity=1,
                                         size_fn=lambda v: 1))
    assert res.n_spills > 0
    rr_iso = TurnipRuntime(tg, res, mode="nondet", policy="random", seed=3,
                           device="cpu").run(inputs)
    prompts = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9]]
    want = oracle(prompts, max_new=6, max_len=64)
    blk = PagedKVCache(pm, 1, 64, block_size=8).block_nbytes
    scfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                       offload=True, hot_window=0, offload_fraction=1.0,
                       preempt_every=3, h2d_bw=500e6, d2h_bw=500e6,
                       disk_bw=300e6)
    pool = HostPool(8 * blk + 2 * rr_iso.peak_host_bytes + 1,
                    policy="priority")
    mem_lease = pool.lease("memgraph", min_bytes=rr_iso.peak_host_bytes,
                           priority=1)
    rt_out: dict = {}

    def run_runtime():
        rt_out["rr"] = TurnipRuntime(tg, res, mode="nondet", policy="random",
                                     seed=3, host_lease=mem_lease,
                                     device="cpu").run(inputs)

    with engine(scfg, pool=pool) as eng:
        t = threading.Thread(target=run_runtime)
        t.start()
        out = eng.generate(prompts, max_new=6)
        t.join(60)
        assert not t.is_alive(), "pooled runtime wedged"
    assert out == want
    for k, w in want_rt.items():
        assert torch.equal(rt_out["rr"].outputs[k], w)
    snap = pool.snapshot()
    assert 0 < snap["peak_bytes"] <= snap["capacity"]
    assert snap["leases"]["memgraph"]["peak"] <= mem_lease.min_bytes
    assert snap["used_bytes"] == 0


# ------------------------------------------------------------ paged cache
def test_paged_cache_block_roundtrip():
    _, _, pm, _ = lms()
    kv = PagedKVCache(pm, 2, 32, block_size=8)
    assert kv.n_blocks == 4
    assert kv.n_token_blocks(0) == 0 and kv.n_token_blocks(9) == 2
    kv.cache["k"][:, 1, 8:16] = 1.5
    view = kv.read_block(1, 1)
    data = {k: v.clone() for k, v in view.items()}
    assert float(data["k"].mean()) == 1.5
    assert sum(d.numel() * d.element_size() for d in data.values()) \
        == kv.block_nbytes
    kv.drop_slot(1)
    assert float(kv.cache["k"][:, 1].abs().max()) == 0.0
    assert float(view["k"].abs().max()) == 0.0   # read_block gives views
    kv.write_block(1, 1, data)
    assert float(kv.cache["k"][:, 1, 8:16].mean()) == 1.5
    kv.grow(4)
    assert kv.cache["k"].shape[1] == 4
    assert float(kv.cache["k"][:, 1, 8:16].mean()) == 1.5
    kv.restore_slot(3, [data, data])
    assert float(kv.cache["k"][:, 3, :16].mean()) == 1.5
    kv.scatter_prefill([0], {k: v[:, :1, :8].clone() + 2
                             for k, v in kv.cache.items()})
    assert float(kv.cache["k"][:, 0, :8].mean()) == 2.0


def test_paged_cache_rejects_recurrent_cache():
    with pytest.raises(ValueError):
        PagedKVCache(_recurrent_model(), 2, 32, block_size=8)
