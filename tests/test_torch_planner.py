"""Plan equality: the port's planner (copied from the reference) builds the
same MEMGRAPH as the reference from the same TASKGRAPH, vertex for vertex,
and its certifiers return the same findings.

Each seeded ``helpers.random_taskgraph`` is replayed into a port
``TaskGraph`` and planned by both packages under the same ``BuildConfig``.
"""
import dataclasses
import random

import pytest

from repro.core.analyze import _corpus_taskgraph as ref_corpus_taskgraph
from repro.core import (BuildConfig as RefBuildConfig, DepKind as RefDepKind,
                        MemgraphOOM as RefOOM, build_memgraph as ref_build,
                        certify as ref_certify,
                        certify_progress as ref_certify_progress,
                        default_pool_config as ref_pool_config)
from repro_torch.core import (BuildConfig, DepKind, MemgraphOOM, TaskGraph,
                              TensorSpec, build_memgraph, certify,
                              certify_progress, default_pool_config, lockcheck)
from repro_torch.core.analyze import _corpus_taskgraph

from helpers import random_taskgraph

SEEDS = range(32)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    """The port's own lock-order sanitizer (tests/conftest.py arms the
    reference's)."""
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def to_port(ref_tg) -> TaskGraph:
    """Replay a reference TASKGRAPH into a port one, vertex by vertex."""
    tg = TaskGraph()
    for tid in sorted(ref_tg.vertices):
        v = ref_tg.vertices[tid]
        new = tg.add(v.kind.value, v.device, v.inputs,
                     TensorSpec(v.out.shape, v.out.dtype), op=v.op,
                     params=dict(v.params), flops=v.flops, name=v.name,
                     streaming=v.streaming)
        assert new == tid
    return tg


def plan_snapshot(res) -> dict:
    """Everything a plan decides, in plain values."""
    mg = res.memgraph
    verts = {}
    for m, v in mg.vertices.items():
        loc = None if v.loc is None else (v.loc.device, v.loc.offset,
                                          v.loc.size)
        verts[m] = (v.op.value, v.device, v.src_tid, loc, v.seq, v.op_name,
                    dict(v.params), v.size, v.nbytes, v.tier, v.prefetch,
                    v.lock_group, tuple(v.operands),
                    tuple(sorted((p, k.value) for p, k in mg.preds[m].items())))
    counters = {f: getattr(res, f) for f in (
        "mid_of", "order", "peak_used", "terminal_host", "n_offloads",
        "n_reloads", "n_cancelled", "peak_host", "n_spills", "n_loads",
        "peak_disk", "n_prefetches", "stall_bytes_hidden",
        "host_residencies")}
    return {"vertices": verts, "counters": counters,
            "superfluous": mg.superfluous_mem_deps}


def _configs(seed: int):
    rng = random.Random(1000 + seed)
    cap = rng.randint(2, 6)
    host = rng.choice([None, None, 3, 5])
    return (dict(capacity=cap, size_fn=lambda v: 1, host_capacity=host,
                 disk_capacity=None), host)


def _build_both(seed: int):
    ref_tg = random_taskgraph(random.Random(seed))
    tg = to_port(ref_tg)
    kw, host = _configs(seed)
    try:
        ref = ref_build(ref_tg, RefBuildConfig(**kw))
    except RefOOM:
        with pytest.raises(MemgraphOOM):
            build_memgraph(tg, BuildConfig(**kw))
        return None
    return ref, build_memgraph(tg, BuildConfig(**kw)), host


@pytest.mark.parametrize("seed", SEEDS)
def test_random_taskgraph_plans_are_equal(seed):
    built = _build_both(seed)
    if built is None:
        return                          # both refused the budget
    ref, res, host = built
    assert plan_snapshot(res) == plan_snapshot(ref)
    assert dataclasses.asdict(certify(res.memgraph, host_capacity=host)) == \
        dataclasses.asdict(ref_certify(ref.memgraph, host_capacity=host))
    assert dataclasses.asdict(certify_progress(
        res.memgraph, default_pool_config(host))) == dataclasses.asdict(
        ref_certify_progress(ref.memgraph, ref_pool_config(host)))


@pytest.mark.parametrize("seed", range(24))
def test_certifier_corpus_plans_are_equal(seed):
    """The certifier CLI's corpus (``analyze.py --seeds 24``), each package
    drawing its own graph and budgets from the same seed: equal graphs,
    equal plans — disk budgets included — and equal certificates."""
    rng, ref_rng = random.Random(1000 + seed), random.Random(1000 + seed)
    tg, ref_tg = _corpus_taskgraph(rng), ref_corpus_taskgraph(ref_rng)
    assert [(v.op, v.device, v.inputs) for v in tg.vertices.values()] == \
        [(v.op, v.device, v.inputs) for v in ref_tg.vertices.values()]
    host = rng.choice((None, 1, 2, 3))
    disk = rng.choice((None, 0, 2, 4, 50)) if host is not None else None
    assert ref_rng.choice((None, 1, 2, 3)) == host
    kw = dict(capacity=3, host_capacity=host, disk_capacity=disk,
              rng_seed=seed, size_fn=lambda v: 1)
    try:
        ref = ref_build(ref_tg, RefBuildConfig(**kw))
    except RefOOM:
        with pytest.raises(MemgraphOOM):
            build_memgraph(tg, BuildConfig(**kw))
        return
    res = build_memgraph(tg, BuildConfig(**kw))
    assert plan_snapshot(res) == plan_snapshot(ref)
    assert dataclasses.asdict(certify(res.memgraph, host_capacity=host,
                                      disk_capacity=disk)) == \
        dataclasses.asdict(ref_certify(ref.memgraph, host_capacity=host,
                                       disk_capacity=disk))


def test_plans_cover_offload_and_disk_tiers():
    """The seed sweep exercises what the planner does under pressure:
    refused budgets, offloads, reloads and disk spills all occur."""
    n_oom = n_off = n_spill = 0
    for seed in SEEDS:
        built = _build_both(seed)
        if built is None:
            n_oom += 1
            continue
        res = built[1]
        n_off += res.n_offloads > 0 and res.n_reloads > 0
        n_spill += res.n_spills > 0
    assert len(SEEDS) - n_oom >= 24
    assert n_off > 0 and n_spill > 0


@pytest.mark.parametrize("seed", [0, 2, 3, 4])   # seed 1's budget is refused
def test_certifiers_agree_on_injected_hazards(seed):
    """Remove each MEM edge in turn from both plans: the two certifiers
    return the same findings (races, budget hazards, witnesses) for every
    cut, and some cut is flagged."""
    ref, res, host = _build_both(seed)
    rmg, mg = ref.memgraph, res.memgraph
    edges = [(u, v) for u in mg.vertices for v, k in mg.succs[u].items()
             if k == DepKind.MEM]
    flagged = 0
    for u, v in edges[:12]:
        rmg.remove_dep(u, v)
        mg.remove_dep(u, v)
        a = dataclasses.asdict(certify(mg, host_capacity=host))
        b = dataclasses.asdict(ref_certify(rmg, host_capacity=host))
        assert a == b
        flagged += not a["ok"]
        rmg.add_dep(u, v, RefDepKind.MEM)
        mg.add_dep(u, v, DepKind.MEM)
    assert flagged > 0 or not edges
