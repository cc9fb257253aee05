"""The paper's second workload (fig11: LoRA fwd+bwd with activation
checkpointing) through the port's runtime, on the CPU.

A tiny LoRA graph (2 layers, S=32, float32), traced by the port and by the
reference, planned under a capacity that forces offload, and run by
``TurnipRuntime(device="cpu")`` under the five policy runs of
``chip_smoke.py`` and under both executor backends. Every adapter gradient
is held against the reference's ``eval_taskgraph`` on the same
``make_inputs`` draw, each gradient alone: max|Δ| ≤ 1e-5 x max|ref| (torch
and numpy sum the products in other orders; the port's rmsnorm accumulates
in float32 where the reference's uses float64). The same plan without
offload, and the port's plain evaluation, are held to the same rule.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.core.runtime import eval_taskgraph as ref_eval
from repro.core.trace import TraceConfig as RefTraceConfig
from repro.core.trace import trace_lora_train as ref_trace_lora
from repro_torch.configs.base import ArchConfig
from repro_torch.core import BuildConfig, build_memgraph, lockcheck
from repro_torch.core.bridge import inputs_from_reference
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.trace import TraceConfig, trace_lora_train

torch.set_num_threads(1)

ARCH = dict(name="demo", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=128, vocab_size=96)
TC = dict(n_devices=2, head_group=2, q_block=16, mlp_slices=2)
SEQ = 32
GRAD_RTOL = 1e-5
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
def lora():
    """The tiny LoRA graph in both packages, plans with and without
    offload, the inputs and the reference's gradients."""
    tr = trace_lora_train(ArchConfig(**ARCH), seq_len=SEQ,
                          trace=TraceConfig(**TC))
    rtr = ref_trace_lora(RefArchConfig(**ARCH), seq_len=SEQ,
                         trace=RefTraceConfig(**TC))
    inputs = rtr.make_inputs(seed=1, scale=0.1)
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    plans = {}
    for name, frac in (("offload", 0.15), ("resident", 1.0)):
        cap = int(total * frac)
        plans[name] = (build_memgraph(tr.tg, BuildConfig(capacity=cap)), cap)
    assert plans["offload"][0].n_offloads > 0
    assert plans["offload"][0].n_reloads > 0
    assert plans["resident"][0].n_offloads == 0
    return tr, plans, inputs, ref_eval(rtr.tg, inputs)


def assert_grads_close(tr, outputs, ref, what):
    assert tr.grad_tids
    for name, tid in tr.grad_tids.items():
        got = outputs[tid].cpu().double().numpy()
        want = np.asarray(ref[tid], dtype=np.float64)
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * scale, \
            f"{what}: grad {name} max|Δ| {err:.3g} > {GRAD_RTOL} x {scale:.3g}"


@pytest.mark.parametrize("exec_backend", ["interpreted", "compiled"])
@pytest.mark.parametrize("policy,mode", RUNS)
def test_lora_grads_match_reference_under_offload(lora, policy, mode,
                                                  exec_backend):
    tr, plans, inputs, ref = lora
    res, cap = plans["offload"]
    rr = TurnipRuntime(tr.tg, res, device="cpu", backend="bytes",
                       capacities={d: cap for d in tr.tg.devices()},
                       policy=policy, mode=mode, seed=0,
                       exec_backend=exec_backend).run(
        inputs_from_reference(inputs, device="cpu"))
    assert rr.offload_bytes > 0 and rr.reload_bytes > 0
    assert_grads_close(tr, rr.outputs, ref, f"{exec_backend}/{policy}/{mode}")
    if exec_backend == "compiled":
        assert rr.n_compiled > 0
        assert rr.n_compiled + rr.n_interpreted == len(res.memgraph)


@pytest.mark.parametrize("exec_backend", ["interpreted", "compiled"])
def test_lora_grads_match_reference_without_offload(lora, exec_backend):
    tr, plans, inputs, ref = lora
    res, cap = plans["resident"]
    rr = TurnipRuntime(tr.tg, res, device="cpu", backend="bytes",
                       capacities={d: cap for d in tr.tg.devices()},
                       policy="critical-path", seed=0,
                       exec_backend=exec_backend).run(inputs)
    assert rr.offload_bytes == 0
    assert_grads_close(tr, rr.outputs, ref, f"resident/{exec_backend}")


def test_lora_plain_evaluation_matches_reference(lora):
    tr, _, inputs, ref = lora
    assert_grads_close(tr, eval_taskgraph(tr.tg, inputs, device="cpu",
                                          plain=True), ref, "plain")


def test_compiled_lora_runs_are_byte_equal(lora):
    """Two compiled runs of one policy give the same bytes: the static
    walker adds into each accumulator in linear order."""
    tr, plans, inputs, _ = lora
    res, cap = plans["offload"]
    rt = TurnipRuntime(tr.tg, res, device="cpu", backend="bytes",
                       capacities={d: cap for d in tr.tg.devices()},
                       policy="critical-path", seed=0,
                       exec_backend="compiled", seam_backend="inline")
    a = rt.run(inputs).outputs
    b = rt.run(inputs).outputs
    for tid in tr.grad_tids.values():
        assert torch.equal(a[tid], b[tid])
