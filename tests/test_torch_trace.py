"""Trace equality: the port's tracer emits the reference's TASKGRAPH —
the same vertices, op names, params, shapes and dtypes — and
``make_inputs(seed)`` draws the same arrays."""
import numpy as np
import pytest

from repro.configs.base import ArchConfig as RefArchConfig
from repro.core.trace import TraceConfig as RefTraceConfig
from repro.core.trace import trace_lora_train as ref_trace_lora_train
from repro.core.trace import trace_prefill as ref_trace_prefill
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import lockcheck
from repro_torch.core.trace import TraceConfig, trace_lora_train, trace_prefill

ARCH = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=4, d_ff=64, vocab_size=48)
TC = dict(n_devices=2, head_group=1, q_block=8, mlp_slices=2, lora_rank=4,
          lora_alpha=8.0)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def graph_snapshot(tr) -> dict:
    verts = {tid: (v.kind.value, v.device, tuple(v.inputs), v.out.shape,
                   v.out.dtype, v.op, dict(v.params), v.flops, v.name,
                   v.streaming)
             for tid, v in tr.tg.vertices.items()}
    return {"vertices": verts, "weights": list(tr.weight_tids),
            "input": tr.input_tid, "grads": dict(tr.grad_tids),
            "meta": dict(tr.meta)}


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("tracer", ["prefill", "lora_train"])
def test_trace_graph_equal(tracer, dtype):
    port_fn, ref_fn = {"prefill": (trace_prefill, ref_trace_prefill),
                       "lora_train": (trace_lora_train,
                                      ref_trace_lora_train)}[tracer]
    tr = port_fn(ArchConfig(**ARCH), seq_len=16,
                 trace=TraceConfig(**TC, dtype=dtype))
    ref = ref_fn(RefArchConfig(**ARCH), seq_len=16,
                 trace=RefTraceConfig(**TC, dtype=dtype))
    assert graph_snapshot(tr) == graph_snapshot(ref)
    for tid, v in tr.tg.vertices.items():
        assert v.out.torch_dtype.itemsize == v.out.np_dtype.itemsize


@pytest.mark.parametrize("seed", [0, 3])
def test_make_inputs_equal(seed):
    tr = trace_prefill(ArchConfig(**ARCH), seq_len=16,
                       trace=TraceConfig(**TC, dtype="float16"))
    ref = ref_trace_prefill(RefArchConfig(**ARCH), seq_len=16,
                            trace=RefTraceConfig(**TC, dtype="float16"))
    a, b = tr.make_inputs(seed, scale=0.1), ref.make_inputs(seed, scale=0.1)
    assert a.keys() == b.keys()
    for tid in a:
        assert a[tid].dtype == b[tid].dtype
        np.testing.assert_array_equal(a[tid], b[tid])


def test_configs_registry_matches_reference():
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import reduced as ref_reduced
    for name, ref_cfg in REF_ARCHS.items():
        cfg = get_arch(name)
        assert cfg.__dict__ == ref_cfg.__dict__
        assert cfg.param_count == ref_cfg.param_count
        assert reduced(cfg).__dict__ == ref_reduced(ref_cfg).__dict__
