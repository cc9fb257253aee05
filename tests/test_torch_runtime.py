"""The slice as a whole, on the CPU: a tiny offloaded prefill traced,
planned and run by the port's runtime, held against the reference's
``eval_taskgraph`` on the same numpy inputs; byte-identical outputs across
dispatch policies on integer-valued graphs; a RaceError when a
safe-overwrite edge is cut; the stores; and the CUDA default.

Tolerance against the reference (float32): rtol 1e-5, atol 1e-6 —
torch's and numpy's matmuls sum in different orders, and the port's
rmsnorm accumulates in float32 where the reference op uses float64.
"""
import copy
import random
import threading

import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.core.runtime import eval_taskgraph as ref_eval
from repro.core.trace import TraceConfig as RefTraceConfig
from repro.core.trace import trace_prefill as ref_trace_prefill
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, DepKind, MemgraphOOM, MemOp,
                              RaceError, TaskGraph, TensorSpec,
                              build_memgraph, certify, lockcheck)
from repro_torch.core.bridge import host_tensor, inputs_from_reference
from repro_torch.core.executor import ExecContext, InlineExecutor
from repro_torch.core.runtime import (ByteArena, SlotTable, TurnipRuntime,
                                      _collect_outputs, eval_taskgraph,
                                      make_store, run_in_order)
from repro_torch.core.stores import DiskStore, HostStore, TieredStore
from repro_torch.core.dispatch import get_policy
from repro_torch.core.trace import TraceConfig, trace_prefill

from helpers import int_inputs, random_taskgraph

# tiny tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ARCH = dict(name="demo", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab_size=96)
TC = dict(n_devices=2, head_group=2, q_block=16, mlp_slices=2)
SEQ = 32
RTOL, ATOL = 1e-5, 1e-6
RUNS = [("random", "nondet"), ("fixed", "nondet"), ("critical-path", "nondet"),
        ("transfer-first", "nondet"), ("fixed", "fixed")]


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


@pytest.fixture(scope="module")
def prefill():
    """The tiny prefill in both packages, its plan under a budget that
    forces offload, and the reference's outputs."""
    tr = trace_prefill(ArchConfig(**ARCH), seq_len=SEQ,
                       trace=TraceConfig(**TC))
    ref_tr = ref_trace_prefill(RefArchConfig(**ARCH), seq_len=SEQ,
                               trace=RefTraceConfig(**TC))
    inputs = ref_tr.make_inputs(seed=1, scale=0.1)
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    cap = int(total * 0.15)
    res = build_memgraph(tr.tg, BuildConfig(capacity=cap))
    return tr, res, cap, inputs, ref_eval(ref_tr.tg, inputs)


def test_prefill_plan_offloads(prefill):
    _, res, _, _, _ = prefill
    assert res.n_offloads > 0 and res.n_reloads > 0


@pytest.mark.parametrize("policy,mode", RUNS)
@pytest.mark.parametrize("backend", ["slots", "bytes"])
def test_offloaded_prefill_matches_reference(prefill, backend, policy, mode):
    tr, res, cap, inputs, ref = prefill
    base = threading.active_count()
    rt = TurnipRuntime(tr.tg, res, device="cpu", backend=backend,
                       capacities={d: cap for d in tr.tg.devices()},
                       policy=policy, mode=mode, seed=0)
    rr = rt.run(inputs_from_reference(inputs, device="cpu"))
    assert threading.active_count() == base
    assert rr.outputs.keys() == ref.keys()
    for tid, want in ref.items():
        np.testing.assert_allclose(rr.outputs[tid].numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    assert rr.offload_bytes > 0 and rr.reload_bytes > 0
    assert len(rr.spans) == len(res.memgraph)
    assert rr.arena_bytes == (2 * cap if backend == "bytes" else 0)


def test_plain_eval_and_run_in_order_match_reference(prefill):
    tr, res, _, inputs, ref = prefill
    ev = eval_taskgraph(tr.tg, inputs, device="cpu", plain=True)
    seq = run_in_order(tr.tg, res, inputs, device="cpu")
    for tid, want in ref.items():
        np.testing.assert_allclose(ev[tid].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(seq[tid].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def test_inline_executor_runs_the_plan(prefill):
    """The thread-free backend: the same kernel and policy on the caller."""
    tr, res, cap, inputs, ref = prefill
    mg = res.memgraph
    mem = ByteArena({d: cap for d in tr.tg.devices()}, "cpu")
    host = make_store(mg, inputs, device="cpu")
    pol = get_policy("critical-path", seed=0)
    pol.prepare(mg)
    members = list(mg.vertices)
    ctx = ExecContext.make(mg, tr.tg, mem, host, pol, "nondet", None, 0.0,
                           members, torch.device("cpu"))
    InlineExecutor(ctx, members).run_subset(members)
    out = _collect_outputs(tr.tg, res, mem, host)
    for tid, want in ref.items():
        np.testing.assert_allclose(out[tid].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def to_port(ref_tg) -> TaskGraph:
    tg = TaskGraph()
    for tid in sorted(ref_tg.vertices):
        v = ref_tg.vertices[tid]
        tg.add(v.kind.value, v.device, v.inputs,
               TensorSpec(v.out.shape, v.out.dtype), op=v.op,
               params=dict(v.params), flops=v.flops, name=v.name,
               streaming=v.streaming)
    return tg


@pytest.mark.parametrize("seed", range(6))
def test_integer_graphs_byte_identical_across_policies(seed):
    """Integer-valued inputs make every op exact, so one plan must give the
    same bytes under every policy, on both memory backends — and equal the
    reference's oracle."""
    ref_tg = random_taskgraph(random.Random(seed))
    tg = to_port(ref_tg)
    ran = set()
    for backend, dtype, unit in (("slots", np.float64, 1),
                                 ("bytes", np.float32, 64)):
        inputs = int_inputs(ref_tg, seed, dtype=dtype)
        want = ref_eval(ref_tg, inputs)
        for cap in (3, 5):
            try:
                res = build_memgraph(tg, BuildConfig(
                    capacity=cap * unit,
                    size_fn=(lambda v: 1) if unit == 1 else None))
            except MemgraphOOM:               # too tight for this graph
                continue
            outs = []
            for policy, mode in RUNS:
                rr = TurnipRuntime(tg, res, device="cpu", backend=backend,
                                   capacities={d: cap * unit
                                               for d in tg.devices()},
                                   policy=policy, mode=mode,
                                   seed=seed).run(inputs)
                outs.append(rr.outputs)
            for out in outs:
                for tid, w in want.items():
                    assert out[tid].numpy().tobytes() == w.tobytes()
            ran.add(backend)
    assert ran == {"slots", "bytes"}


def test_cut_safe_overwrite_edge_raises_race_error(prefill):
    """Cut one safe-overwrite (MEM) edge: the certifier names the race and
    replaying its witness order through the port's interpreter raises
    RaceError (the overwritten extent is read as a different value)."""
    tr, res, _, inputs, _ = prefill
    res = copy.deepcopy(res)
    mg = res.memgraph
    edges = [(u, v) for u in mg.vertices for v, k in mg.succs[u].items()
             if k == DepKind.MEM]
    for u, v in edges:
        mg.remove_dep(u, v)
        cert = certify(mg)
        for h in cert.hazards:
            if h.confirmable and h.witness_kind == "race" and h.witness:
                try:
                    run_in_order(tr.tg, res, inputs, list(h.witness),
                                 device="cpu")
                except RaceError:
                    return
        mg.add_dep(u, v, DepKind.MEM)
    pytest.fail("no cut MEM edge replayed to a RaceError")


def test_compiled_backend_matches_reference_prefill(prefill):
    """The compiled backend runs the offloaded prefill to the reference's
    outputs, and an unknown backend is refused."""
    tr, res, cap, inputs, ref = prefill
    rr = TurnipRuntime(tr.tg, res, device="cpu", backend="bytes",
                       capacities={d: cap for d in tr.tg.devices()},
                       exec_backend="compiled", policy="critical-path",
                       seed=0).run(inputs_from_reference(inputs,
                                                         device="cpu"))
    assert rr.n_compiled > 0
    assert rr.n_compiled + rr.n_interpreted == len(res.memgraph)
    for tid, want in ref.items():
        np.testing.assert_allclose(rr.outputs[tid].numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="executor backend"):
        TurnipRuntime(tr.tg, res, device="cpu", exec_backend="jit")


def test_entry_points_default_to_cuda(prefill):
    """No silent CPU path: without CUDA, every entry point raises unless
    the caller passes device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tr, res, _, inputs, _ = prefill
    for call in (lambda: TurnipRuntime(tr.tg, res),
                 lambda: eval_taskgraph(tr.tg, inputs),
                 lambda: run_in_order(tr.tg, res, inputs),
                 lambda: HostStore(inputs),
                 lambda: SlotTable(),
                 lambda: ByteArena({0: 64}),
                 lambda: inputs_from_reference(inputs)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_bridge_carries_bfloat16_by_name():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.arange(-4, 4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    t = inputs_from_reference({0: a}, device="cpu")[0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    with pytest.raises(ValueError):     # a CUDA store takes pinned tensors
        host_tensor(torch.zeros(2), pin=True)


def test_tiered_store_spills_through_the_disk_log(tmp_path):
    """Offload copies, spill to the spill.log, read back through the disk
    tier: bytes and dtypes survive, bfloat16 included."""
    vals = {"f32": torch.randn(3, 5), "f16": torch.randn(4).half(),
            "bf16": torch.randn(2, 2).to(torch.bfloat16),
            "i32": torch.arange(6, dtype=torch.int32)}
    st = TieredStore({}, device="cpu", directory=tmp_path, auto_spill=False)
    try:
        for k, v in vals.items():
            st.put_offload(k, v)
            assert st.offloaded[k] is not v           # a host copy
            assert st.spill(k) > 0
            assert st.tier_of(k) == "disk"
        assert (tmp_path / "spill.log").exists()
        for k, v in vals.items():
            got = st.get_offload(k)
            assert got.dtype == v.dtype and torch.equal(got, v)
        assert st.disk.read_bytes == st.disk.write_bytes
    finally:
        st.close()
    d = DiskStore(tmp_path / "kv")
    try:
        d.put("blk", {"k": vals["bf16"], "v": vals["f16"]})
        got = d.get("blk")
        assert torch.equal(got["k"], vals["bf16"])
        assert torch.equal(got["v"], vals["f16"])
    finally:
        d.close()


def test_disk_tier_plan_runs_on_the_port():
    """A plan with SPILL/LOAD vertices (bounded host tier) runs over the
    port's TieredStore and matches the reference oracle exactly."""
    for seed in range(40):
        ref_tg = random_taskgraph(random.Random(seed))
        tg = to_port(ref_tg)
        try:
            res = build_memgraph(tg, BuildConfig(
                capacity=3, size_fn=lambda v: 1, host_capacity=2))
        except MemgraphOOM:
            continue
        if not any(v.op == MemOp.SPILL for v in res.memgraph.vertices.values()):
            continue
        inputs = int_inputs(ref_tg, seed)
        want = ref_eval(ref_tg, inputs)
        rr = TurnipRuntime(tg, res, device="cpu", seed=seed).run(inputs)
        assert rr.disk_spill_bytes > 0
        for tid, w in want.items():
            assert rr.outputs[tid].numpy().tobytes() == w.tobytes()
        return
    pytest.fail("no seed produced a disk-tier plan")

