"""The port's plan compiler (``repro_torch.core.compile``) on the CPU.

*Plan equality*: both packages' ``lower()`` of the same plan give the same
linear order, the same instructions (mid, engine, stream, ready tick,
region, batch head), the same regions (start, end, kind, seam backend),
the same fused batches and the same ``verify()`` outcome — over the
seeded corpus of ``python -m repro.core.compile --seeds 24`` and over a
tiny offloading prefill and LoRA fwd+bwd plan, under all four policies.

*The compiled backend*: on integer-valued graphs (every op exact) the
compiled backend gives the interpreted backend's bytes under every
policy, both modes and the three seam backends, on both memory backends;
and the CLI replays the corpus byte-exactly.
"""
import dataclasses
import random as pyrandom

import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.core import BuildConfig as RefBuildConfig
from repro.core import MemgraphOOM as RefOOM
from repro.core import build_memgraph as ref_build
from repro.core.analyze import _corpus_taskgraph as ref_corpus
from repro.core.compile import PlanCompileError as RefPlanCompileError
from repro.core.compile import lower as ref_lower
from repro.core.liveness import certify_progress as ref_certify_progress
from repro.core.liveness import default_pool_config as ref_pool_config
from repro.core.trace import TraceConfig as RefTraceConfig
from repro.core.trace import trace_lora_train as ref_trace_lora
from repro.core.trace import trace_prefill as ref_trace_prefill
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, MemgraphOOM, TaskGraph,
                              build_memgraph, certify_progress,
                              default_pool_config, lockcheck)
from repro_torch.core.analyze import _corpus_taskgraph
from repro_torch.core.compile import (INLINE, NONDET, STATIC, THREADED,
                                      PlanCompileError, lower, main)
from repro_torch.core.dispatch import POLICY_NAMES
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.trace import TraceConfig, trace_lora_train, \
    trace_prefill

from helpers import fig3_taskgraph, random_taskgraph
from test_torch_differential import port_inputs, to_port

torch.set_num_threads(1)

UNITS = dict(size_fn=lambda v: 1)
RUNS = [("random", "nondet"), ("fixed", "nondet"), ("critical-path", "nondet"),
        ("transfer-first", "nondet"), ("fixed", "fixed")]
ARCH = dict(name="demo", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab_size=96)
TC = dict(n_devices=2, head_group=2, q_block=16, mlp_slices=2)
SEQ = 32


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def plan_snapshot(plan, mg) -> dict:
    try:
        plan.verify(mg)
        verified = "ok"
    except (PlanCompileError, RefPlanCompileError) as e:
        verified = str(e)
    return {
        "order": list(plan.order),
        "instrs": [(i.mid, i.pos, i.device, i.engine, i.stream,
                    i.ready_tick, i.region, i.batch) for i in plan.instrs],
        "regions": [(r.start, r.end, r.kind, r.backend)
                    for r in plan.regions],
        "batches": list(plan.batches),
        "batch_heads": dict(plan.batch_heads),
        "certified": plan.certified,
        "liveness_certified": plan.liveness_certified,
        "seam_threshold": plan.seam_threshold,
        "verify": verified,
    }


def _corpus_pair(seed: int):
    """Both packages' plans of one corpus seed, built as the CLIs build
    them (with a liveness certificate when the proof goes through); None
    when the plan is rejected at compile time (in both)."""
    out = []
    for corpus, cfg_cls, build, oom, cprog, pool in (
            (ref_corpus, RefBuildConfig, ref_build, RefOOM,
             ref_certify_progress, ref_pool_config),
            (_corpus_taskgraph, BuildConfig, build_memgraph, MemgraphOOM,
             certify_progress, default_pool_config)):
        rng = pyrandom.Random(1000 + seed)
        tg = corpus(rng)
        host_cap = rng.choice((None, 1, 2, 3))
        disk_cap = rng.choice((None, 0, 2, 4, 50)) \
            if host_cap is not None else None
        cfg = cfg_cls(capacity=3, host_capacity=host_cap,
                      disk_capacity=disk_cap, rng_seed=seed, **UNITS,
                      backend="compiled")
        try:
            res = build(tg, cfg)
        except oom:
            out.append(None)
            continue
        lcert = cprog(res.memgraph, pool(cfg.host_budget()),
                      disk_capacity=cfg.disk_capacity)
        if lcert.ok:
            res.liveness_certificate = lcert
        out.append(res)
    return out


@pytest.mark.parametrize("seed", range(24))
def test_lower_equals_reference_on_the_corpus(seed):
    ref_res, res = _corpus_pair(seed)
    assert (ref_res is None) == (res is None)
    if res is None:
        return
    for pol in POLICY_NAMES:
        got = plan_snapshot(lower(res, policy=pol, seed=seed), res.memgraph)
        want = plan_snapshot(ref_lower(ref_res, policy=pol, seed=seed),
                             ref_res.memgraph)
        assert got == want, pol
        assert got["verify"] == "ok"


def _tiny_pair(kind: str):
    """The tiny offloading prefill or LoRA fwd+bwd plan in both packages,
    with 64-byte extents."""
    port_fn, ref_fn = {"prefill": (trace_prefill, ref_trace_prefill),
                       "lora": (trace_lora_train, ref_trace_lora)}[kind]
    tr = port_fn(ArchConfig(**ARCH), seq_len=SEQ, trace=TraceConfig(**TC))
    rtr = ref_fn(RefArchConfig(**ARCH), seq_len=SEQ,
                 trace=RefTraceConfig(**TC))
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    cap = int(total * 0.15)

    def size_fn(v):
        return -(-v.out.nbytes // 64) * 64

    res = build_memgraph(tr.tg, BuildConfig(capacity=cap, size_fn=size_fn))
    ref_res = ref_build(rtr.tg, RefBuildConfig(capacity=cap,
                                               size_fn=size_fn))
    assert res.n_offloads > 0 and res.n_reloads > 0
    return tr, res, rtr, ref_res, cap


@pytest.fixture(scope="module", params=["prefill", "lora"])
def tiny(request):
    return _tiny_pair(request.param)


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_lower_equals_reference_on_tiny_plans(tiny, policy):
    _, res, _, ref_res, _ = tiny
    got = plan_snapshot(lower(res, policy=policy, seed=3), res.memgraph)
    want = plan_snapshot(ref_lower(ref_res, policy=policy, seed=3),
                         ref_res.memgraph)
    assert got == want
    assert got["verify"] == "ok"
    assert any(k == NONDET for _, _, k, _ in got["regions"])
    assert any(k == STATIC for _, _, k, _ in got["regions"])


@pytest.mark.parametrize("corrupt", ["tick", "permutation", "regions",
                                     "backend-stamp"])
def test_verify_rejects_what_the_reference_rejects(corrupt):
    """A corrupted plan fails ``verify()`` in both packages."""
    plans = []
    for tg, build, cfg_cls in ((fig3_taskgraph(), ref_build, RefBuildConfig),
                               (to_port(fig3_taskgraph()), build_memgraph,
                                BuildConfig)):
        res = build(tg, cfg_cls(capacity=3, **UNITS))
        fn = ref_lower if build is ref_build else lower
        plan = fn(res, policy="fixed")
        if corrupt == "tick":
            plan.instrs[-1] = dataclasses.replace(
                plan.instrs[-1], ready_tick=plan.n_vertices + 5)
        elif corrupt == "permutation":
            plan.order[0] = plan.order[1]
        elif corrupt == "regions":
            r = plan.regions[0]
            plan.regions[0] = dataclasses.replace(r, start=r.start + 1)
        else:
            i = next(i for i, r in enumerate(plan.regions)
                     if r.kind == NONDET)
            plan.regions[i] = dataclasses.replace(plan.regions[i],
                                                  backend="")
        plans.append((plan, res.memgraph))
    msgs = []
    for plan, mg in plans:
        with pytest.raises((PlanCompileError, RefPlanCompileError)) as ei:
            plan.verify(mg)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _runs_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


@pytest.mark.parametrize("seam_backend", ["auto", INLINE, THREADED])
@pytest.mark.parametrize("seed", range(6))
def test_compiled_is_byte_exact_against_interpreted(seed, seam_backend):
    """Integer-valued graphs: the compiled backend gives the interpreted
    backend's bytes (and the reference oracle's) under every policy, both
    modes, on both memory backends."""
    ref_tg = random_taskgraph(pyrandom.Random(seed))
    tg = to_port(ref_tg)
    ran = 0
    for backend, dtype, unit in (("slots", np.float64, 1),
                                 ("bytes", np.float32, 64)):
        inputs = {t: a.astype(dtype)
                  for t, a in port_inputs(tg, seed).items()}
        want = eval_taskgraph(tg, inputs, device="cpu")
        for cap in (3, 5):
            try:
                res = build_memgraph(tg, BuildConfig(
                    capacity=cap * unit,
                    size_fn=(lambda v: 1) if unit == 1 else None))
            except MemgraphOOM:
                continue
            for policy, mode in RUNS:
                outs = {}
                for exec_backend in ("interpreted", "compiled"):
                    rr = TurnipRuntime(
                        tg, res, device="cpu", backend=backend,
                        capacities={d: cap * unit for d in tg.devices()},
                        policy=policy, mode=mode, seed=seed,
                        exec_backend=exec_backend,
                        seam_backend=seam_backend).run(inputs)
                    outs[exec_backend] = rr.outputs
                    if exec_backend == "compiled":
                        n = len(res.memgraph)
                        assert rr.n_compiled + rr.n_interpreted == n
                        assert rr.n_inline + rr.n_threaded == \
                            rr.n_interpreted
                        if seam_backend == INLINE:
                            assert rr.n_threaded == 0
                        if seam_backend == THREADED:
                            assert rr.n_inline == 0
                    else:
                        assert rr.n_compiled == 0
                        assert rr.n_interpreted == len(res.memgraph)
                _runs_equal(outs["compiled"], outs["interpreted"])
                _runs_equal(outs["compiled"], want)
            ran += 1
    assert ran > 0


def _chain(n: int = 8) -> TaskGraph:
    """One input, a unary chain: exactly one legal order."""
    tg = TaskGraph()
    t = tg.add_input(0, (4, 4), name="in")
    for i in range(n):
        t = tg.add_compute(0, (t,), (4, 4), op="relu", name=f"c{i}")
    return tg


def test_backend_flows_from_build_config():
    """``BuildConfig(backend='compiled')`` selects the compiled backend; a
    unary chain has one legal order and runs fully straight-line."""
    tg = _chain()
    res = build_memgraph(tg, BuildConfig(capacity=3, backend="compiled",
                                         **UNITS))
    rt = TurnipRuntime(tg, res, device="cpu")
    assert rt.exec_backend == "compiled"
    inputs = port_inputs(tg)
    rr = rt.run(inputs)
    assert rr.n_compiled == len(res.memgraph) and rr.n_interpreted == 0
    assert rr.fused_dma_batches == 0
    _runs_equal(rr.outputs, eval_taskgraph(tg, inputs, device="cpu"))
    assert len(rr.spans) == len(res.memgraph)
    with pytest.raises(ValueError, match="backend"):
        TurnipRuntime(tg, res, device="cpu", exec_backend="jit")
    with pytest.raises(ValueError, match="seam backend"):
        TurnipRuntime(tg, res, device="cpu", seam_backend="gpu")


def test_fused_batches_counted_by_the_compiled_backend():
    """A liveness-certified tiered plan fuses DMA runs (disk runs and the
    H2D/D2H pair among them); the compiled backend counts the fused
    submissions it issued and stays byte-exact."""
    for seed in range(20):
        ref_tg = random_taskgraph(pyrandom.Random(1000 + seed))
        tg = to_port(ref_tg)
        try:
            res = build_memgraph(tg, BuildConfig(
                capacity=3, rng_seed=seed, host_capacity=2, disk_capacity=50,
                certify_liveness=True, **UNITS))
        except MemgraphOOM:
            continue
        if not lower(res, policy="fixed").batches:
            continue
        inputs = port_inputs(tg, seed)
        rr = TurnipRuntime(tg, res, policy="fixed", seed=seed, device="cpu",
                           exec_backend="compiled").run(inputs)
        assert rr.fused_dma_batches > 0
        _runs_equal(rr.outputs, eval_taskgraph(tg, inputs, device="cpu"))
        return
    pytest.fail("no seed produced a fused tiered plan")


def test_cli_corpus_lowers_and_replays(capsys):
    assert main(["--seeds", "24", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 failed" in out
