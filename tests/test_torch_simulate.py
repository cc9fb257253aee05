"""The port's discrete-event simulator (``repro_torch.core.simulate``).

*Simulation equality*: the same memgraph and the same ``HardwareModel``
(jitter and pool contention included) give the same ``SimResult`` in both
packages — makespan, busy, stall, channel time, timeline and every
vertex's start and done instants — for ``nondet`` under every policy and
for ``fixed``, with and without a compiled plan's fused batches; and the
migration pricing functions agree. Then twins of
``tests/test_simulate.py``'s five tests, and the measured H100 model.
"""
import dataclasses
import random as pyrandom

import pytest

from repro.core import BuildConfig as RefBuildConfig
from repro.core import TaskGraph as RefTaskGraph
from repro.core import build_memgraph as ref_build
import repro.core.simulate as ref_sim
from repro.core.compile import lower as ref_lower
from repro_torch.core import BuildConfig, MemgraphOOM, build_memgraph
from repro_torch.core import lockcheck
from repro_torch.core.compile import lower
from repro_torch.core.dispatch import POLICY_NAMES
from repro_torch.core.simulate import (H100_MEASURED, HardwareModel,
                                       SimResult, migration_crossover,
                                       price_migration, price_reprefill,
                                       simulate)

from helpers import fig3_taskgraph, random_taskgraph
from test_torch_compile import _tiny_pair
from test_torch_differential import to_port

HW_PARAMS = [dict(),
             dict(transfer_jitter=0.7, compute_jitter=0.3, seed=5),
             dict(transfer_jitter=0.4, pool_contention=0.3, seed=2,
                  flops=1e14, h2d_bw=25e9)]


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def layered_graph(L=6, T=4, D=512, B=256):
    tg = RefTaskGraph()
    x = tg.add_input(0, (B, D), name="x")
    h = x
    tile = D // T
    for l in range(L):
        tiles = []
        for t in range(T):
            w = tg.add_input(0, (D, tile), name=f"w{l}.{t}")
            tiles.append(tg.add_compute(0, (h, w), (B, tile), op="matmul",
                                        flops=2 * B * D * tile,
                                        name=f"mm{l}.{t}"))
        cat = tg.add_compute(0, tuple(tiles), (B, D), op="concat",
                             params={"axis": -1}, name=f"cat{l}")
        h = tg.add_compute(0, (cat,), (B, D), op="gelu", flops=8 * B * D,
                           name=f"act{l}")
    return tg


def sim_snapshot(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _pairs():
    """(name, ref BuildResult, port BuildResult) over several graphs."""
    out = []
    for name, ref_tg, cfg in [
            ("fig3", fig3_taskgraph(), dict(capacity=3, size_fn=lambda v: 1)),
            ("fig3-tiered", fig3_taskgraph(),
             dict(capacity=3, host_capacity=1, size_fn=lambda v: 1)),
            ("layered", layered_graph(L=4, T=4),
             dict(capacity=3 * 512 * 256 * 4))]:
        out.append((name, ref_build(ref_tg, RefBuildConfig(**cfg)),
                    build_memgraph(to_port(ref_tg), BuildConfig(**cfg))))
    for seed in range(4):
        ref_tg = random_taskgraph(pyrandom.Random(1000 + seed))
        cfg = dict(capacity=3, host_capacity=2, disk_capacity=50,
                   rng_seed=seed, size_fn=lambda v: 1)
        try:
            res = build_memgraph(to_port(ref_tg), BuildConfig(**cfg))
        except MemgraphOOM:
            continue
        out.append((f"random{seed}", ref_build(ref_tg, RefBuildConfig(**cfg)),
                    res))
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("hw", range(len(HW_PARAMS)))
@pytest.mark.parametrize("case", [p[0] for p in PAIRS])
def test_simulation_equals_reference(case, hw):
    _, ref_res, res = next(p for p in PAIRS if p[0] == case)
    params = HW_PARAMS[hw]
    rhw, phw = ref_sim.HardwareModel(**params), HardwareModel(**params)
    for mode, policies in (("nondet", POLICY_NAMES), ("fixed", ("fixed",))):
        for pol in policies:
            got = simulate(res.memgraph, phw, mode=mode, policy=pol,
                           record_timeline=True)
            want = ref_sim.simulate(ref_res.memgraph, rhw, mode=mode,
                                    policy=pol, record_timeline=True)
            assert sim_snapshot(got) == sim_snapshot(want), (mode, pol)


@pytest.mark.parametrize("kind", ["prefill", "lora"])
def test_simulation_of_tiny_plans_equals_reference(kind):
    """The tiny offloading prefill and LoRA plans, plain and priced with
    the compiled plan's fused batches."""
    _, res, _, ref_res, _ = _tiny_pair(kind)
    params = dict(transfer_jitter=0.5, seed=1)
    for mode in ("nondet", "fixed"):
        for fused in (False, True):
            pf = lower(res, policy="fixed").fused_map if fused else None
            rf = ref_lower(ref_res, policy="fixed").fused_map \
                if fused else None
            assert pf == rf
            got = simulate(res.memgraph, HardwareModel(**params), mode=mode,
                           fused=pf)
            want = ref_sim.simulate(ref_res.memgraph,
                                    ref_sim.HardwareModel(**params),
                                    mode=mode, fused=rf)
            assert sim_snapshot(got) == sim_snapshot(want)


def test_migration_pricing_equals_reference():
    for params in HW_PARAMS:
        p, r = HardwareModel(**params), ref_sim.HardwareModel(**params)
        assert price_migration(p, n_blocks=5, block_nbytes=1 << 20,
                               disk_blocks=2) == \
            ref_sim.price_migration(r, n_blocks=5, block_nbytes=1 << 20,
                                    disk_blocks=2)
        assert price_reprefill(p, tokens=300, flops_per_token=1e9,
                               kv_nbytes=1 << 22) == \
            ref_sim.price_reprefill(r, tokens=300, flops_per_token=1e9,
                                    kv_nbytes=1 << 22)
        kw = dict(block_size=16, block_nbytes=1 << 18, flops_per_token=2e9,
                  disk_frac=0.5)
        assert migration_crossover(p, **kw) == \
            ref_sim.migration_crossover(r, **kw)


def test_default_model_is_the_references():
    """The defaults are the paper's P100 figures, as in the reference."""
    assert dataclasses.asdict(HardwareModel()) == \
        dataclasses.asdict(ref_sim.HardwareModel())


def test_h100_model_is_measured():
    """The named H100 instance carries measured rates: every rate and
    latency positive, the copy engines faster than the paper's PCIe 3."""
    hw = H100_MEASURED
    assert isinstance(hw, HardwareModel)
    for f in ("flops", "hbm_bw", "h2d_bw", "d2h_bw", "kernel_overhead",
              "dma_latency"):
        assert getattr(hw, f) > 0, f
    assert hw.h2d_bw > HardwareModel().h2d_bw
    assert hw.hbm_bw > hw.h2d_bw


# --------------------------------------- twins of tests/test_simulate.py
def _port_build(ref_tg, **cfg):
    return build_memgraph(to_port(ref_tg), BuildConfig(**cfg))


def test_simulates_all_vertices():
    res = _port_build(fig3_taskgraph(), capacity=3, size_fn=lambda v: 1)
    sim = simulate(res.memgraph, HardwareModel())
    assert isinstance(sim, SimResult)
    assert sim.n_vertices == len(res.memgraph)
    assert sim.makespan > 0


@pytest.mark.parametrize("mode", ["nondet", "fixed"])
def test_deterministic_given_seed(mode):
    res = _port_build(layered_graph(), capacity=2 * 512 * 256 * 4)
    hw = HardwareModel(transfer_jitter=0.7, seed=3)
    a = simulate(res.memgraph, hw, mode=mode)
    b = simulate(res.memgraph, hw, mode=mode)
    assert a.makespan == b.makespan


def test_fixed_never_faster_than_nondet_with_jitter():
    res = _port_build(layered_graph(L=8, T=8), capacity=3 * 512 * 256 * 4)
    worse = 0
    for seed in range(5):
        hw = HardwareModel(transfer_jitter=1.0, seed=seed)
        nd = simulate(res.memgraph, hw, mode="nondet")
        fx = simulate(res.memgraph, hw, mode="fixed")
        assert fx.makespan >= nd.makespan * 0.999
        worse += fx.makespan > nd.makespan * 1.001
    assert worse >= 1


def test_memory_pressure_increases_makespan():
    tg = layered_graph(L=8, T=8)
    big = _port_build(tg, capacity=64 * 512 * 256 * 4)
    small = _port_build(tg, capacity=int(3 * 512 * 256 * 4))
    hw = HardwareModel()
    assert simulate(small.memgraph, hw).makespan >= \
        simulate(big.memgraph, hw).makespan


def test_timeline_recording():
    res = _port_build(fig3_taskgraph(), capacity=5, size_fn=lambda v: 1)
    sim = simulate(res.memgraph, HardwareModel(), record_timeline=True)
    assert len(sim.timeline) == sim.n_vertices
    for t0, t1, dev, eng, _name in sim.timeline:
        assert t1 >= t0 >= 0
