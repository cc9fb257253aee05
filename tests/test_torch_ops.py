"""Op parity: every op of the port's registry against the reference's
numpy op on the same numpy inputs, in float32 and float16, with and
without a preallocated ``out`` extent.

Tolerances: float32 rtol 1e-5, atol 1e-6 x max|reference| — torch and
numpy sum products and reductions in different orders, and the port's
rmsnorm accumulates in float32 where the reference op uses float64
(ROADMAP C6). float16 rtol 1e-2, atol 1e-2 x max|reference| — numpy
rounds float16 intermediates where torch keeps float32 accumulators.
"""
import math

import numpy as np
import pytest
import torch

from repro.core.ops import OPS as REF_OPS
from repro.core.ops import get_op as ref_get_op
from repro_torch.core import lockcheck
from repro_torch.core.ops import OPS, get_op
from repro_torch.core.trace import TraceConfig, trace_prefill
from repro_torch.configs.base import ArchConfig

# tiny tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-6), "float16": (1e-2, 1e-2)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _softmax_rows(rng, shape):
    e = np.exp(rng.standard_normal(shape))
    return e / e.sum(-1, keepdims=True)


# op -> (operand makers (rng -> float64 array), params)
CASES = {
    "copy": ([(4, 6)], {}),
    "add": ([(4, 6), (4, 6)], {}),
    "sum": ([(4, 6), (4, 6), (4, 6)], {}),
    "mul": ([(4, 6), (4, 6)], {}),
    "scale": ([(4, 6)], {"alpha": 0.5}),
    "matmul": ([(4, 6), (6, 5)], {}),
    "matmul_t": ([(4, 6), (5, 6)], {}),
    "relu": ([(4, 6)], {}),
    "gelu": ([(4, 6)], {}),
    "silu": ([(4, 6)], {}),
    "tanh": ([(4, 6)], {}),
    "transpose": ([(4, 6)], {}),
    "slice_rows": ([(6, 4)], {"start": 1, "stop": 4}),
    "concat": ([(2, 3, 4), (2, 5, 4)], {"axis": 1}),
    "rmsnorm": ([(6, 32), (32,)], {"eps": 1e-6}),
    "softmax": ([(2, 4, 8)], {}),
    "scores": ([(2, 4, 8), (2, 16, 8)],
               {"scale": 1 / math.sqrt(8), "causal": True, "q_offset": 8}),
    "attn_out": ([(2, 4, 16), (2, 16, 8)], {}),
    "lora_delta": ([(4, 8), (2, 8), (6, 2)], {"alpha": 4.0, "rank": 2}),
    "matmul_tn": ([(5, 4), (5, 3)], {}),
    "softmax_bwd": (["softmax(2,4,8)", (2, 4, 8)], {}),
    "gelu_bwd": ([(4, 6), (4, 6)], {}),
    "rmsnorm_bwd": ([(6, 32), (32,), (6, 32)], {"eps": 1e-6}),
    "split_heads": ([(6, 8)], {"n_heads": 2}),
    "merge_heads": ([(2, 6, 4)], {}),
    "slice_rows_3d": ([(2, 8, 4)], {"start": 2, "stop": 5}),
    "zeros": ([], {"shape": (3, 4), "dtype": "float32"}),
}


def test_registry_covers_the_reference():
    assert set(OPS) == set(REF_OPS) == set(CASES)


def test_trace_ops_are_covered():
    tr = trace_prefill(ArchConfig(name="t", family="dense", n_layers=1,
                                  d_model=32, n_heads=4, n_kv_heads=4,
                                  d_ff=64, vocab_size=48), seq_len=16,
                       trace=TraceConfig(n_devices=2, head_group=2,
                                         q_block=8))
    assert {v.op for v in tr.tg.vertices.values() if v.op != "input"} <= \
        set(CASES)


def _operands(name, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes, params = CASES[name]
    arrs = []
    for s in shapes:
        a = (_softmax_rows(rng, (2, 4, 8)) if s == "softmax(2,4,8)"
             else rng.standard_normal(s))
        arrs.append(a.astype(dtype))
    return arrs, params


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name, dtype):
    arrs, params = _operands(name, dtype)
    ref = np.asarray(ref_get_op(name)(*arrs, **params))
    fn = get_op(name)
    out = fn(*[torch.from_numpy(a) for a in arrs], **params)
    assert tuple(out.shape) == ref.shape
    assert str(out.dtype).removeprefix("torch.") == ref.dtype.name
    rtol, atol = TOL[dtype]
    finite = np.isfinite(ref)
    scale = float(np.abs(ref[finite]).max()) if finite.any() else 1.0
    got = out.float().numpy()
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], ref[~finite].astype(np.float32))
    np.testing.assert_allclose(got[finite], ref[finite].astype(np.float32),
                               rtol=rtol, atol=atol * max(scale, 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_writes_into_out(name):
    """With ``out`` (a view into a byte buffer, as an arena extent) an op
    returns ``out`` holding exactly the bytes it returns without it."""
    arrs, params = _operands(name, "float32", seed=1)
    fn = get_op(name)
    vals = [torch.from_numpy(a) for a in arrs]
    fresh = fn(*vals, **params)
    buf = torch.zeros(fresh.numel() * fresh.element_size() + 8,
                      dtype=torch.uint8)
    dest = buf[4:4 + fresh.numel() * fresh.element_size()] \
        .view(fresh.dtype).view(fresh.shape)
    got = fn(*vals, out=dest, **params)
    assert got.data_ptr() == dest.data_ptr()
    assert torch.equal(dest, fresh)
    for v, a in zip(vals, arrs):            # operands are never written
        np.testing.assert_array_equal(v.numpy(), a)


def test_scores_mask_is_the_reference_constant():
    """-1e30 as numpy casts it: -inf in float16, -1e30 in float32."""
    q = torch.ones(1, 2, 4)
    k = torch.ones(1, 4, 4)
    s32 = get_op("scores")(q, k, causal=True, q_offset=0)
    s16 = get_op("scores")(q.half(), k.half(), causal=True, q_offset=0)
    assert s32[0, 0, 1].item() == np.float32(-1e30)
    assert s16[0, 0, 1].item() == -math.inf
    p = get_op("softmax")(s16)
    assert torch.isfinite(p).all()
