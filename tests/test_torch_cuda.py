"""The port on the card. Every test here needs CUDA: it carries the
``cuda`` marker and skips without a card. The file imports neither JAX nor
the reference's JAX modules, so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, MemgraphOOM, TaskGraph, TensorSpec,
                              build_memgraph, lockcheck)
from repro_torch.core import ops as port_ops
from repro_torch.core.bridge import inputs_from_reference
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.trace import TraceConfig, trace_prefill
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain
from repro_torch.models import build_model
from repro_torch.serve import (Engine, PagedKVCache, RELOAD_POLICY_NAMES,
                               ServeConfig, naive_generate)

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


# (B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset): tests/test_kernels.py's
# sweep, two chunks of queries against a longer KV, and llama-7b's heads
FLASH_CASES = [(2, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 4, 4, 128, True, 0),
               (2, 64, 256, 8, 2, 64, False, 0), (1, 256, 64, 2, 1, 64, True, 0),
               (1, 64, 256, 4, 2, 32, True, 192),
               (2, 100, 300, 8, 8, 128, True, 200),
               (2, 96, 96, 32, 32, 128, True, 0)]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    """One launch per call; the kernel's f32 online softmax against the
    materialised f32 scores of the plain version (TF32 off, so the plain
    f32 products are full f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Skv, Hq, Hkv, Dh, causal, off = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device=cuda).to(dtype)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    rtol, atol = KERNEL_TOL[dtype]
    torch.testing.assert_close(
        o.float(), flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=off).float(),
        rtol=rtol, atol=atol)


def test_flash_kernel_reads_strided_views_and_writes_out(cuda):
    """q, k, v sliced out of one fused projection whose rows are 513
    floats long, one float in (unaligned strides), and ``out`` a view into
    a wider buffer: no copies, same result."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 80, 8 * 64 + 1, generator=gen, device=cuda)
    heads = x[..., 1:].view(2, 80, 8, 64)
    q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
    buf = torch.zeros(2, 80, 5, 64, device=cuda)
    out = buf[:, :, 1:]
    assert flash_attention(q, k, v, out=out) is out
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-5)
    assert float(buf[:, :, 0].abs().max()) == 0.0


def test_flash_wrapper_refuses_what_it_cannot_launch(cuda):
    q = torch.randn(1, 16, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)                 # k on another device
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], q[..., :48], q[..., :48])  # head size


def _serving_model(cuda, arch="llama-7b"):
    """A reduced float32 model on the card and its twin on the CPU, with
    the same parameters."""
    cfg = reduced(get_arch(arch))
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    return cpu_model, params, build_model(cfg, device=cuda), to(params)


PROMPTS = [list(range(1, 25)), list(range(30, 48)), [7, 8, 9, 10, 11]]


@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_engine_on_card_matches_cpu_oracle(cuda, policy):
    """Offload and preemption over the real copy streams: the greedy
    tokens equal the port's naive_generate run on the CPU with the same
    parameters (float32, TF32 off), and every kernel launch is counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model, params, model, gparams = _serving_model(cuda)
    want = [naive_generate(cpu_model, params, p, max_new=8, max_len=64,
                           rid=i) for i, p in enumerate(PROMPTS)]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=8,
                      offload=True, hot_window=0, preempt_every=3,
                      reload_policy=policy)
    fa0, rms0 = flash_attention.launches, rmsnorm.launches
    with Engine(model, gparams, cfg) as eng:
        assert eng.generate(PROMPTS, max_new=8) == want
        st = eng.stats
        assert st.swaps >= 1 and st.offload_bytes > 0 and st.reload_bytes > 0
        assert eng.host.resident_bytes == 0
    L = model.cfg.n_layers
    assert flash_attention.launches - fa0 == L * st.prefill_calls
    assert rmsnorm.launches - rms0 == (2 * L + 1) * (st.prefill_calls
                                                     + st.decode_steps)


def test_d2h_copies_wait_for_the_compute_stream(cuda, monkeypatch):
    """ROADMAP C3. Every cache write is held back by a ~10 ms spin kernel
    on the compute stream, so a d2h copy that started when the engine
    lock was released, instead of after the compute stream's write
    event, would read stale bytes. Each mirrored block must equal the
    device bytes of its extent, in pinned host memory, and the tokens
    must stay the oracle's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model, params, model, gparams = _serving_model(cuda)
    want = [naive_generate(cpu_model, params, p, max_new=8, max_len=64,
                           rid=i) for i, p in enumerate(PROMPTS)]

    def spin():
        torch.cuda._sleep(20_000_000)

    real_scatter = PagedKVCache.scatter_prefill

    def slow_scatter(self, slots, kv):
        spin()
        real_scatter(self, slots, kv)
    monkeypatch.setattr(PagedKVCache, "scatter_prefill", slow_scatter)
    real_step = model.decode_step

    def slow_step(*a, **kw):
        spin()
        return real_step(*a, **kw)
    model.decode_step = slow_step

    cfg = ServeConfig(max_len=64, batch_buckets=(1,), block_size=8,
                      offload=True, hot_window=0, preempt_every=3)
    with Engine(model, gparams, cfg) as eng:
        checked = []
        real_put = eng.host.put_offload

        def put(key, value, *, copy=True):      # engine lock held
            assert not copy
            rid, blk = key
            assert all(t.is_pinned() for t in value.values())
            torch.cuda.synchronize()
            dev = eng.kv.read_block(eng.reqs[rid].slot, blk)
            for name, t in value.items():
                assert torch.equal(t, dev[name].cpu()), (key, name)
            checked.append(key)
            real_put(key, value, copy=copy)
        eng.host.put_offload = put
        assert eng.generate(PROMPTS, max_new=8) == want
        assert eng.stats.swaps >= 1 and len(checked) >= 3
