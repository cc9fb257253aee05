"""The port on the card. Every test here needs CUDA: it carries the
``cuda`` marker and skips without a card. The file imports neither JAX nor
the reference's JAX modules, so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, MemgraphOOM, TaskGraph, TensorSpec,
                              build_memgraph, lockcheck)
from repro_torch.core import ops as port_ops
from repro_torch.core.bridge import inputs_from_reference
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.trace import TraceConfig, trace_prefill
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain

from helpers import int_inputs, random_taskgraph

pytestmark = pytest.mark.cuda

RUNS = [("random", "nondet"), ("fixed", "nondet"), ("critical-path", "nondet"),
        ("transfer-first", "nondet"), ("fixed", "fixed")]
# kernel vs plain: about one unit in the last place of the storage type
KERNEL_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2),
              torch.float16: (2e-3, 2e-3)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(7, 128), (3, 33, 256), (1, 512),
                                   (2048, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    """On a CUDA tensor the wrapper launches the kernel (one count per
    call), into a fresh output and into an unaligned arena-like view."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape[-1:], generator=gen, device=cuda).to(dtype)
    before = rmsnorm.launches
    y = rmsnorm(x, g)
    es, nb = x.element_size(), x.numel() * x.element_size()
    buf = torch.zeros(nb + es, dtype=torch.uint8, device=cuda)
    view = buf[es:].view(dtype).view(shape)      # not 16-byte aligned
    assert rmsnorm(x, g, out=view) is view
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 2
    p = rmsnorm_plain(x, g).float()
    rtol, atol = KERNEL_TOL[dtype]
    for got in (y, view):
        torch.testing.assert_close(got.float(), p, rtol=rtol, atol=atol)


def test_kernel_wrapper_refuses_what_it_cannot_launch(cuda):
    x = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError):
        rmsnorm(x, torch.randn(8))                     # g on another device
    with pytest.raises(ValueError):
        rmsnorm(x.t(), torch.randn(4, device=cuda))    # strided last dim


@pytest.mark.parametrize("backend", ["slots", "bytes"])
def test_offloaded_prefill_on_card(cuda, backend):
    """A tiny prefill planned to offload, run on the card with pinned host
    inputs and CUDA streams: float32 logits within 1e-4 of the plain
    evaluation (summation order of the streaming sums and the kernel's
    rounding), one rmsnorm launch per norm, everything on the card."""
    tr = trace_prefill(ArchConfig(name="demo", family="dense", n_layers=2,
                                  d_model=64, n_heads=4, n_kv_heads=4,
                                  d_ff=128, vocab_size=96), seq_len=32,
                       trace=TraceConfig(n_devices=2, head_group=2,
                                         q_block=16, mlp_slices=2))
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    cap = int(total * 0.15)
    res = build_memgraph(tr.tg, BuildConfig(capacity=cap))
    assert res.n_offloads > 0 and res.n_reloads > 0
    host = inputs_from_reference(tr.make_inputs(seed=1, scale=0.1),
                                 device=cuda)
    assert all(t.is_pinned() for t in host.values())
    plain = eval_taskgraph(tr.tg, host, device=cuda, plain=True)
    n_norms = sum(v.op == "rmsnorm" for v in tr.tg.vertices.values())
    for policy, mode in RUNS:
        before = rmsnorm.launches
        rr = TurnipRuntime(tr.tg, res, backend=backend, policy=policy,
                           mode=mode, seed=0, device=cuda,
                           capacities={d: cap for d in tr.tg.devices()}
                           ).run(host)
        assert rmsnorm.launches - before == n_norms
        if backend == "bytes":
            assert rr.arena_device.startswith("cuda")
        for tid, want in plain.items():
            assert rr.outputs[tid].device.type == "cuda"
            torch.testing.assert_close(rr.outputs[tid], want, rtol=1e-4,
                                       atol=1e-5)


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
def test_slow_kernels_keep_safe_overwrite_order(cuda, monkeypatch, seed):
    """ROADMAP C1: every compute op first spins ~1 ms on its stream, so a
    launch returns long before its work is done. Completion taken from the
    op's return would let a successor on another stream read an extent
    still being written, or an overwrite clobber one still being read;
    event-synchronised completion keeps the outputs byte-exact under every
    policy, on the arena with tight, reused extents."""
    for name in ("add", "mul", "matmul", "matmul_t", "relu", "copy"):
        fn = port_ops.OPS[name]

        def slow(*xs, _fn=fn, **kw):
            torch.cuda._sleep(2_000_000)
            return _fn(*xs, **kw)
        monkeypatch.setitem(port_ops.OPS, name, slow)
    ref_tg = random_taskgraph(random.Random(seed))
    tg = to_port(ref_tg)
    inputs = int_inputs(ref_tg, seed, dtype=np.float32)
    want = eval_taskgraph(tg, inputs, device="cpu")
    host = inputs_from_reference(inputs, device=cuda)
    for cap in (3, 5):
        try:
            res = build_memgraph(tg, BuildConfig(capacity=cap * 64))
        except MemgraphOOM:
            continue
        for policy, mode in RUNS:
            rr = TurnipRuntime(tg, res, backend="bytes", policy=policy,
                               mode=mode, seed=seed, device=cuda,
                               capacities={d: cap * 64 for d in tg.devices()}
                               ).run(host)
            for tid, w in want.items():
                assert torch.equal(rr.outputs[tid].cpu(), w)
