"""The port on the card. Every test here needs CUDA: it carries the
``cuda`` marker and skips without a card. The file imports neither JAX nor
the reference's JAX modules, so it runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os
import dataclasses
import random

# one cuBLAS workspace of 4 MiB per (handle, stream), fixed before the
# process first calls cuBLAS: the HBM bound of the C2 test counts them
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:1")

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (BuildConfig, MemgraphOOM, TaskGraph, TensorSpec,
                              build_memgraph, lockcheck)
from repro_torch.core import ops as port_ops
from repro_torch.core.bridge import inputs_from_reference
from repro_torch.core.compile import NONDET, STATIC, Region, lower
from repro_torch.core.memgraph import MemOp
from repro_torch.core.runtime import TurnipRuntime, eval_taskgraph
from repro_torch.core.trace import TraceConfig, trace_prefill
from repro_torch.kernels.flash_attention.ops import (attention_limit,
                                                     flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.moe_gmm.ops import (grouped_matmul,
                                             grouped_matmul_bwd_plain,
                                             grouped_matmul_plain, moe_gmm,
                                             moe_gmm_bwd, moe_gmm_plain)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain
from repro_torch.kernels.rwkv6.ops import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                           wkv6_plain)
from repro_torch.kernels.ssd_scan.ops import (ssd_scan, ssd_scan_bwd,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_plain)
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
# sweep, two chunks of queries against a longer KV, and llama-7b's heads;
# then the 16-bit kernel's edges (64-row KV tiles, 128-row query tiles):
# one query row, KV shorter than a tile or no multiple of it, and a chunk
# of queries at an offset at zamba2-7b's head size
FLASH_CASES = [(2, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 4, 4, 128, True, 0),
               (2, 64, 256, 8, 2, 64, False, 0), (1, 256, 64, 2, 1, 64, True, 0),
               (1, 64, 256, 4, 2, 32, True, 192),
               (2, 100, 300, 8, 8, 128, True, 200),
               (2, 96, 96, 32, 32, 128, True, 0),
               (2, 200, 200, 4, 4, 112, True, 0),     # zamba2-7b's heads
               (1, 96, 160, 8, 8, 112, False, 0),
               (2, 1, 100, 4, 2, 128, True, 99), (2, 1, 37, 4, 4, 64, False, 0),
               (1, 130, 40, 4, 4, 112, True, 0), (2, 70, 24, 4, 2, 64, False, 0),
               (2, 150, 150, 4, 4, 128, True, 0), (1, 64, 130, 4, 2, 32, False, 0),
               (1, 100, 300, 4, 4, 112, True, 200)]


def _assert_attention_close(o, want):
    """float32: KERNEL_TOL; 16-bit: attention_limit (two units in the last
    place plus a share of each row's rms)."""
    name = str(o.dtype).removeprefix("torch.")
    err = (o.float() - want.float()).abs()
    ratio = (err / attention_limit(want, name)).max().item()
    assert ratio <= 1.0, f"max err/limit {ratio:.3g} ({name})"


def _count_flash():
    return (flash_attention.launches, flash_attention.launches_tc,
            flash_attention.launches_scalar)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_matches_plain_on_card(cuda, case, dtype):
    """One launch per call, on the wgmma instance in 16 bits and the scalar
    one in float32; the kernel's f32 online softmax against the
    materialised f32 scores of the plain version (TF32 off, so the plain
    f32 products are full f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Skv, Hq, Hkv, Dh, causal, off = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device=cuda).to(dtype)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    n, tc, sc = _count_flash()
    o = flash_attention(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert _count_flash() == (n + 1, tc + (not f32), sc + f32)
    assert o.dtype == dtype and o.shape == q.shape
    _assert_attention_close(o, flash_attention_plain(q, k, v, causal=causal,
                                                     q_offset=off))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_unaligned_16bit_views(cuda, dtype):
    """q, k, v sliced out of 513-element rows, one element in: no pointer
    or stride is 16-byte aligned, so the wgmma kernel stages its tiles
    with element loads; still the tensor-core instance, not the scalar."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 80, 8 * 64 + 1, generator=gen, device=cuda).to(dtype)
    heads = x[..., 1:].view(2, 80, 8, 64)
    q, k, v = heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:]
    n, tc, sc = _count_flash()
    o = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _count_flash() == (n + 1, tc + 1, sc)
    _assert_attention_close(o, flash_attention_plain(q, k, v))
    # the aligned copies give the same bytes
    assert torch.equal(o, flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_is_deterministic_and_batch_invariant(cuda, dtype):
    """Two launches give equal bytes, and row b = 0 of a batch of 8 equals
    the same row run alone, byte for byte: a row's result depends only on
    its own (b, h, row), never on B or the grid."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(8, 300, 8, 112, generator=gen, device=cuda
                           ).to(dtype) for _ in range(3))
    o = flash_attention(q, k, v)
    assert torch.equal(o, flash_attention(q, k, v))
    alone = flash_attention(q[:1], k[:1], v[:1])
    torch.cuda.synchronize()
    assert torch.equal(o[:1], alone)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_one_query_row_writes_only_its_row(cuda, dtype):
    """decode_step's cross-attention: one query row a batch row against
    1500 keys (head size 64, bidirectional) on the tensor-core instance,
    written into rows of a wider buffer: the row within the attention
    limit of the plain version, finite, and the buffer's other rows (those
    a 128-row tile would cover past Sq) left as they were."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(4, 1, 16, 64, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(4, 1500, 16, 64, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    buf = torch.full((4, 128, 16, 64), 7.0, dtype=dtype, device=cuda)
    out = buf[:, :1]
    n_tc = flash_attention.launches_tc
    flash_attention(q, k, v, causal=False, out=out)
    torch.cuda.synchronize()
    assert flash_attention.launches_tc == n_tc + 1
    want = flash_attention_plain(q, k, v, causal=False)
    assert bool(torch.isfinite(out.float()).all())
    name = str(dtype).removeprefix("torch.")
    assert bool(((out.float() - want.float()).abs()
                 <= attention_limit(want, name)).all())
    assert bool((buf[:, 1:] == 7.0).all())


def test_flash_wrapper_refuses_what_it_cannot_launch(cuda):
    q = torch.randn(1, 16, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)                 # k on another device
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], q[..., :48], q[..., :48])  # head size


def gmm_tol(dtype, d: int) -> tuple[float, float]:
    """KERNEL_TOL, with the float32 absolute part grown to 1e-6 x D: the
    kernel and cuBLAS add a row's D products in other orders, and each
    order's rounding grows with the partial sums over D terms."""
    rtol, atol = KERNEL_TOL[dtype]
    if dtype == torch.float32:
        atol = max(atol, 1e-6 * d)
    return rtol, atol


# grouped matmul: (label, R, D, F, [(offset, count) per group]); rows in
# no group must keep what ``out`` held
GMM_CASES = [
    ("empty-and-full", 40, 64, 48, [(0, 0), (0, 40), (40, 0)]),
    ("unaligned-widths", 37, 33, 130, [(0, 5), (5, 1), (6, 31)]),
    ("rows-outside-groups", 300, 96, 136, [(3, 100), (120, 0), (120, 7),
                                           (140, 150)]),
    ("decode-like", 48, 2048, 1408, [(0, 2)] + [(2 + i, 1) for i in range(30)]
     + [(32, 16)] + [(48, 0)] * 32),
    ("tile-edges", 513, 256, 200, [(0, 64), (64, 65), (129, 127), (256, 257)]),
]


@pytest.mark.parametrize("case", GMM_CASES, ids=[c[0] for c in GMM_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_moe_gmm_kernel_matches_plain_on_card(cuda, case, dtype):
    """One launch per call; the kernel against the plain loop over groups
    (TF32 off), and rows in no group untouched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, R, D, F, groups = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(R, D, generator=gen, device=cuda).to(dtype)
    w = torch.randn(len(groups), D, F, generator=gen, device=cuda).to(dtype)
    offsets = torch.tensor([o for o, _ in groups], dtype=torch.int32,
                           device=cuda)
    counts = torch.tensor([c for _, c in groups], dtype=torch.int32,
                          device=cuda)
    out = torch.full((R, F), 7.0, dtype=dtype, device=cuda)
    before = moe_gmm.launches
    assert grouped_matmul(x, w, offsets, counts, out=out) is out
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    want = grouped_matmul_plain(x, w, offsets, counts,
                                out=torch.full_like(out, 7.0))
    rtol, atol = gmm_tol(dtype, D)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_moe_gmm_kernel_reads_views_and_the_dense_interface(cuda, dtype):
    """x rows at an odd stride and offset (the kernel's element-load path),
    a layer's view w[i] of stacked weights, and the reference's
    dense-grouped ``moe_gmm`` on the sweep of tests/test_kernels.py."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(1)
    rtol, atol = gmm_tol(dtype, 96)
    big = torch.randn(70, 97, generator=gen, device=cuda).to(dtype)
    x = big[:, 1:]                                   # [70, 96], stride 97
    stacked = torch.randn(3, 4, 96, 72, generator=gen, device=cuda).to(dtype)
    offsets = torch.tensor([0, 10, 10, 40], dtype=torch.int32, device=cuda)
    counts = torch.tensor([10, 0, 30, 30], dtype=torch.int32, device=cuda)
    got = grouped_matmul(x, stacked[2], offsets, counts)
    torch.cuda.synchronize()
    want = grouped_matmul_plain(x, stacked[2], offsets, counts)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    for E, C, D, F in [(4, 100, 96, 130), (2, 64, 64, 64), (8, 16, 48, 32)]:
        xe = torch.randn(E, C, D, generator=gen, device=cuda).to(dtype)
        we = torch.randn(E, D, F, generator=gen, device=cuda).to(dtype)
        torch.testing.assert_close(moe_gmm(xe, we).float(),
                                   moe_gmm_plain(xe, we).float(), rtol=rtol,
                                   atol=atol)


def test_moe_block_is_batch_invariant_on_card(cuda):
    """A token's MoE output does not depend on the other rows of its batch:
    one moonshot-width layer (2048 -> 64 experts of 1408, top-6, bf16)
    over 663 tokens alone and as the first rows of 6144, bit for bit. The
    grouped matmul computes each row on its own; the router logits are
    rounded from an f64 product, since cuBLAS's f32 product sums a row in
    an order that depends on the number of rows."""
    from repro_torch.models.layers import moe_block, moe_init
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = moe_init(gen, 2048, 1408, 64, torch.bfloat16, device=cuda)
    x = torch.randn(1, 6144, 2048, generator=gen, device=cuda).to(
        torch.bfloat16)
    kw = dict(n_experts=64, top_k=6, capacity_factor=None)
    alone, _ = moe_block(p, x[:, :663], **kw)
    batched, _ = moe_block(p, x, **kw)
    assert torch.equal(alone, batched[:, :663])


def test_moe_gmm_wrapper_refuses_what_it_cannot_launch(cuda):
    x = torch.randn(8, 16, device=cuda)
    w = torch.randn(2, 16, 4, device=cuda)
    off = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    cnt = torch.tensor([4, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        grouped_matmul(x, w, off.cpu(), cnt)           # offsets on the host
    with pytest.raises(ValueError):
        grouped_matmul(x, w.cpu(), off, cnt)           # w on another device
    with pytest.raises(TypeError):
        grouped_matmul(x.double(), w.double(), off, cnt)


def _moonshot_routed(cuda, n_tokens: int, seed: int):
    """x rows [n_tokens * 6, 2048] and int32 offsets, counts of moonshot's
    routing (64 experts, top-6) of random tokens by a random router; and
    the generator, for the weights."""
    from repro_torch.models.layers import moe_route
    gen = torch.Generator(device=cuda).manual_seed(seed)
    router = torch.randn(2048, 64, generator=gen, device=cuda) / 2048 ** 0.5
    x = torch.randn(n_tokens, 2048, generator=gen, device=cuda)
    _, _, perm, off, cnt = moe_route(torch.softmax(x @ router, -1), 6)
    return gen, x[perm // 6], off.int(), cnt.int()


@pytest.mark.parametrize("product", ["gate", "down"])
def test_moe_gmm_routed_serving_prefill_on_wgmma(cuda, product):
    """The serving prefill's routed rows (8 x 768 tokens, top-6: 36,864
    rows) through moonshot's gate (2048 -> 1408) and down (1408 -> 2048)
    products in bfloat16: on the wgmma instance, two launches byte-equal,
    and the plain version under gmm_tol."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, x, off, cnt = _moonshot_routed(cuda, 8 * 768, 3)
    K, N = (2048, 1408) if product == "gate" else (1408, 2048)
    if product == "down":
        x = torch.randn(x.shape[0], K, generator=gen, device=cuda)
    x = x.bfloat16()
    w = torch.randn(64, K, N, generator=gen, device=cuda).bfloat16()
    before = moe_gmm.launches_wgmma
    y = grouped_matmul(x, w, off, cnt)
    again = grouped_matmul(x, w, off, cnt)
    torch.cuda.synchronize()
    assert moe_gmm.launches_wgmma == before + 2
    assert torch.equal(y, again)
    rtol, atol = gmm_tol(torch.bfloat16, K)
    torch.testing.assert_close(y.float(), grouped_matmul_plain(
        x, w, off, cnt).float(), rtol=rtol, atol=atol)


def test_moe_gmm_group_alone_is_byte_equal_to_the_full_call(cuda):
    """A group's rows computed alone (R = its count, one expert) are byte
    for byte its rows in the routed call of 36,864 rows: no tile or
    instance depends on R or on the other groups."""
    gen, x, off, cnt = _moonshot_routed(cuda, 8 * 768, 4)
    x = x.bfloat16()
    w = torch.randn(64, 2048, 1408, generator=gen, device=cuda).bfloat16()
    full = grouped_matmul(x, w, off, cnt)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    for e in {int(cnt.argmax()), int(cnt.argmin()), 17}:
        o, c = int(off[e]), int(cnt[e])
        if c == 0:
            continue
        alone = grouped_matmul(x[o:o + c].contiguous(), w[e:e + 1], zero,
                               torch.tensor([c], dtype=torch.int32,
                                            device=cuda))
        assert torch.equal(alone, full[o:o + c]), e


def test_moe_gmm_counts_launches_by_instance(cuda):
    """Aligned 16-bit views go to the wgmma instance; a view at an odd
    stride and offset, which TMA cannot read, to the mma.sync one; float32
    to the scalar one. ``launches`` counts them all."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    big = torch.randn(70, 97, generator=gen, device=cuda).bfloat16()
    w = torch.randn(4, 96, 72, generator=gen, device=cuda).bfloat16()
    off = torch.tensor([0, 10, 10, 40], dtype=torch.int32, device=cuda)
    cnt = torch.tensor([10, 0, 30, 30], dtype=torch.int32, device=cuda)
    for x, w_, instance in [(big[:, :96].contiguous(), w, "launches_wgmma"),
                            (big[:, 1:], w, "launches_mma"),
                            (big[:, 1:].float(), w.float(),
                             "launches_scalar")]:
        before = {a: getattr(moe_gmm, a) for a in (
            "launches", "launches_wgmma", "launches_mma", "launches_scalar")}
        grouped_matmul(x, w_, off, cnt)
        torch.cuda.synchronize()
        after = {a: getattr(moe_gmm, a) - n for a, n in before.items()}
        assert after == {a: int(a in ("launches", instance)) for a in after}


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


@pytest.mark.parametrize("policy", RELOAD_POLICY_NAMES)
def test_moe_engine_on_card_matches_cpu_oracle(cuda, policy):
    """Reduced granite-moe-1b, float32: offload and preemption over the
    real copy streams; the greedy tokens equal the port's naive_generate
    on the CPU with the same parameters, and every forward launches the
    grouped-matmul kernel three times per layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model, params, model, gparams = _serving_model(
        cuda, "granite-moe-1b-a400m")
    want = [naive_generate(cpu_model, params, p, max_new=8, max_len=64,
                           rid=i) for i, p in enumerate(PROMPTS)]
    cfg = ServeConfig(max_len=64, batch_buckets=(1, 2), block_size=8,
                      offload=True, hot_window=0, preempt_every=3,
                      reload_policy=policy)
    fa0, rms0, gmm0 = (flash_attention.launches, rmsnorm.launches,
                       moe_gmm.launches)
    with Engine(model, gparams, cfg) as eng:
        assert eng.generate(PROMPTS, max_new=8) == want
        st = eng.stats
        assert st.swaps >= 1 and st.offload_bytes > 0 and st.reload_bytes > 0
    L = model.cfg.n_layers
    forwards = st.prefill_calls + st.decode_steps
    assert flash_attention.launches - fa0 == L * st.prefill_calls
    assert rmsnorm.launches - rms0 == (2 * L + 1) * forwards
    assert moe_gmm.launches - gmm0 == 3 * L * forwards


# the scans, tests/test_kernels.py's sweeps (S padding included) and one
# long case each: (B, S, H, P, N, chunk) and (B, S, H, P, chunk)
SSD_CASES = [(2, 100, 3, 32, 16, 32), (1, 64, 2, 64, 64, 16),
             (2, 33, 1, 16, 8, 64), (1, 1000, 4, 64, 64, 128)]
WKV_CASES = [(2, 100, 3, 32, 25), (1, 31, 2, 64, 8), (2, 64, 1, 16, 64),
             (1, 1000, 4, 64, 32)]
# tests/test_kernels.py's float32 tolerances; bfloat16 as KERNEL_TOL
SCAN_TOL = {"ssd_scan": {torch.float32: (5e-4, 5e-4),
                         torch.bfloat16: (3e-2, 3e-2)},
            "wkv6": {torch.float32: (1e-3, 1e-3),
                     torch.bfloat16: (3e-2, 3e-2)}}


def _ssd_inputs(cuda, B, S, H, P, N, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype)
    dt = torch.randn(B, S, H, generator=gen, device=cuda).abs().to(dtype)
    A = -torch.randn(H, generator=gen, device=cuda).abs()
    Bm = torch.randn(B, S, N, generator=gen, device=cuda).to(dtype)
    Cm = torch.randn(B, S, N, generator=gen, device=cuda).to(dtype)
    return x, dt, A, Bm, Cm


def _wkv_inputs(cuda, B, S, H, P, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    lw = (-torch.exp(torch.randn(B, S, H, P, generator=gen, device=cuda))
          ).clamp(-20, 0).to(dtype)
    u = torch.randn(H, P, generator=gen, device=cuda)
    return r, k, v, lw, u


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_on_card(cuda, case, dtype):
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(cuda, B, S, H, P, N, dtype)
    before = ssd_scan.launches
    y = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    rtol, atol = SCAN_TOL["ssd_scan"][dtype]
    torch.testing.assert_close(y.float(),
                               ssd_scan_plain(*args, chunk=chunk).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", WKV_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain_on_card(cuda, case, dtype):
    B, S, H, P, chunk = case
    args = _wkv_inputs(cuda, B, S, H, P, dtype)
    before = wkv6.launches
    y = wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    rtol, atol = SCAN_TOL["wkv6"][dtype]
    torch.testing.assert_close(y.float(),
                               wkv6_plain(*args, chunk=chunk).float(),
                               rtol=rtol, atol=atol)


def test_scan_wrappers_refuse_what_they_cannot_launch(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 16, 2, 8, 4, torch.float32)
    before = ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A.cpu(), Bm, Cm)               # A on the host
    with pytest.raises(ValueError):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm)          # mixed dtypes
    with pytest.raises(ValueError):
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm,
                 Cm)                                   # not contiguous
    with pytest.raises(ValueError):                    # P above 64
        ssd_scan(torch.zeros(1, 16, 2, 96, device=cuda), dt, A, Bm, Cm)
    with pytest.raises(ValueError):                    # N above 64
        big = torch.zeros(1, 16, 80, device=cuda)
        ssd_scan(x, dt, A, big, big)
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dt.double(), A, Bm.double(), Cm.double())
    with pytest.raises(TypeError):                     # no float16 instance
        ssd_scan(x.half(), dt.half(), A, Bm.half(), Cm.half())
    assert ssd_scan.launches == before
    r, k, v, lw, u = _wkv_inputs(cuda, 1, 16, 2, 8, torch.float32)
    before = wkv6.launches
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw.bfloat16(), u)                # mixed dtypes
    with pytest.raises(ValueError):
        wkv6(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, lw, u)
    with pytest.raises(ValueError):                    # chunk above 64
        wkv6(r.repeat(1, 8, 1, 1), k.repeat(1, 8, 1, 1), v.repeat(1, 8, 1, 1),
             lw.repeat(1, 8, 1, 1), u, chunk=128)
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u.cpu())                     # u on the host
    with pytest.raises(ValueError):                    # P above 64
        big = torch.zeros(1, 16, 2, 96, device=cuda)
        wkv6(big, big, big, big, torch.zeros(2, 96, device=cuda))
    with pytest.raises(TypeError):                     # no float16 instance
        wkv6(r.half(), k.half(), v.half(), lw.half(), u)
    assert wkv6.launches == before


def test_ssd_scan_on_zamba_ranges_against_float64(cuda):
    """zamba2-7b's input ranges (softplus'd dt, A = -linspace(1, 16)) at
    S = 8192, chunk 128: the kernel's error against a float64 evaluation
    of the model's recurrence is at most twice the plain version's
    (chip_smoke.py's ssd_model_range rule)."""
    from repro_torch.models.ssm import _ssd_chunked
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, S, H, P, N = 1, 8192, 8, 64, 64
    x = torch.randn(B, S, H, P, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=cuda))
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    Bm = torch.randn(B, S, N, generator=gen, device=cuda)
    Cm = torch.randn(B, S, N, generator=gen, device=cuda)
    args = (x, dt, A, Bm, Cm)
    y = ssd_scan(*args, chunk=128)
    p = ssd_scan_plain(*args, chunk=128)
    h0 = torch.zeros(B, H, P, N, dtype=torch.float64, device=cuda)
    exact, _ = _ssd_chunked(*(t.double() for t in args), chunk=128, h0=h0)
    err_k = (y.double() - exact).abs().max().item()
    err_p = (p.double() - exact).abs().max().item()
    assert err_k <= 2 * err_p, (err_k, err_p)


@pytest.mark.parametrize("S,chunk", [(1000, 16), (1000, 32), (1000, 64),
                                     (8191, 128), (130, 128)])
def test_ssd_scan_chunk_sizes_and_ragged_tails(cuda, S, chunk):
    """Chunks of 16, 32, 64 and 128, with a last chunk shorter than the
    others (S not a multiple of the chunk), float32 against the plain
    version at SCAN_TOL."""
    args = _ssd_inputs(cuda, 2, S, 3, 64, 64, torch.float32, seed=7)
    y = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL["ssd_scan"][torch.float32]
    torch.testing.assert_close(y, ssd_scan_plain(*args, chunk=chunk),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_odd_head_and_state_sizes(cuda, dtype):
    """P = 30 and N = 15: P * N is no multiple of 4 (the state pass's
    one-element path) and rows of x are no multiple of 16 bytes."""
    args = _ssd_inputs(cuda, 2, 300, 3, 30, 15, dtype, seed=9)
    y = ssd_scan(*args, chunk=64)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL["ssd_scan"][dtype]
    torch.testing.assert_close(y.float(), ssd_scan_plain(
        *args, chunk=64).float(), rtol=rtol, atol=atol)


def test_ssd_scan_is_deterministic_and_counts_its_launches(cuda):
    """Two calls give the same bytes; each call counts one in ``launches``
    and its three device launches in ``kernel_launches``."""
    args = _ssd_inputs(cuda, 2, 700, 5, 64, 64, torch.float32, seed=8)
    before = (ssd_scan.launches, ssd_scan.kernel_launches)
    y = ssd_scan(*args, chunk=128)
    again = ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert (ssd_scan.launches - before[0],
            ssd_scan.kernel_launches - before[1]) == (2, 6)


def test_wkv6_on_the_models_decay_range(cuda):
    """rwkv6-7b's log decays, -exp(N(0, 2) - 6) clipped at -20, at
    1 x 4096 with 8 heads of 64, chunk 32: float32 against the plain
    version at SCAN_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    r, k, v = (torch.randn(1, 4096, 8, 64, generator=gen, device=cuda)
               for _ in range(3))
    lw = (-torch.exp(torch.randn(1, 4096, 8, 64, generator=gen, device=cuda)
                     * 2.0 - 6.0)).clamp(-20, 0)
    u = torch.randn(8, 64, generator=gen, device=cuda)
    y = wkv6(r, k, v, lw, u, chunk=32)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL["wkv6"][torch.float32]
    torch.testing.assert_close(y, wkv6_plain(r, k, v, lw, u, chunk=32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("chunk", [8, 25, 32, 64])
@pytest.mark.parametrize("S", [1, 31, 33, 127, 129, 1000])
def test_wkv6_chunk_sizes_and_ragged_tails(cuda, S, chunk):
    """Chunks of 8, 25, 32 and 64 (both tile instances), S below, at and
    past a chunk and its groups, with a last chunk shorter than the others:
    float32 against the plain version at SCAN_TOL."""
    args = _wkv_inputs(cuda, 2, S, 3, 64, torch.float32, seed=7)
    y = wkv6(*args, chunk=chunk)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL["wkv6"][torch.float32]
    torch.testing.assert_close(y, wkv6_plain(*args, chunk=chunk),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_odd_head_size_and_unaligned_rows(cuda, dtype):
    """P = 30 (rows no multiple of 4 elements: the kernel's element loads),
    and P = 64 views one element past an aligned start."""
    args = _wkv_inputs(cuda, 2, 300, 3, 30, dtype, seed=9)
    y = wkv6(*args, chunk=32)
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL["wkv6"][dtype]
    torch.testing.assert_close(y.float(), wkv6_plain(
        *args, chunk=32).float(), rtol=rtol, atol=atol)
    r, k, v, lw, u = _wkv_inputs(cuda, 1, 200, 2, 64, dtype, seed=10)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    views = [shifted(t) for t in (r, k, v, lw)]
    y = wkv6(*views, u, chunk=32)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), wkv6_plain(
        r, k, v, lw, u, chunk=32).float(), rtol=rtol, atol=atol)


def test_wkv6_is_deterministic_and_counts_its_launches(cuda):
    """Two calls give the same bytes; each call counts one in ``launches``
    and its three device launches in ``kernel_launches``."""
    args = _wkv_inputs(cuda, 2, 700, 5, 64, torch.float32, seed=8)
    before = (wkv6.launches, wkv6.kernel_launches)
    y = wkv6(*args, chunk=32)
    again = wkv6(*args, chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert (wkv6.launches - before[0],
            wkv6.kernel_launches - before[1]) == (2, 6)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_apply_on_card_matches_cpu(cuda, arch):
    """A reduced float32 model (TF32 off): ``apply`` on the card through the
    scan kernels against the same model on the CPU (the plain versions),
    with each kernel launched once per layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model, params, model, gparams = _serving_model(cuda, arch)
    gen = torch.Generator().manual_seed(1)

    def perturb(tree, gtree):            # the zero-initialised leaves
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                perturb(leaf, gtree[name])
            elif not leaf.any():
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
                gtree[name].copy_(leaf)
    perturb(params, gparams)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 150)))
    want = cpu_model.apply(params, toks)
    counts = (ssd_scan.launches, wkv6.launches, flash_attention.launches)
    got = model.apply(gparams, toks.to(cuda))
    torch.cuda.synchronize()
    L = model.cfg.n_layers
    if arch == "rwkv6-7b":
        assert wkv6.launches - counts[1] == L
    else:
        ng = L // model.cfg.zamba_group
        assert ssd_scan.launches - counts[0] == L
        assert flash_attention.launches - counts[2] == ng
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------ the compiled backend
def _tiny_prefill(cuda, dtype="float32", frac=0.15, n_devices=2):
    tr = trace_prefill(ArchConfig(name="demo", family="dense", n_layers=2,
                                  d_model=64, n_heads=4, n_kv_heads=4,
                                  d_ff=128, vocab_size=96), seq_len=32,
                       trace=TraceConfig(n_devices=n_devices, head_group=2,
                                         q_block=16, mlp_slices=2,
                                         dtype=dtype))
    total = sum(v.out.nbytes for v in tr.tg.vertices.values()
                if v.device == 0)
    cap = int(total * frac)
    res = build_memgraph(tr.tg, BuildConfig(
        capacity=cap, size_fn=lambda v: -(-v.out.nbytes // 256) * 256))
    host = inputs_from_reference(tr.make_inputs(seed=1, scale=0.1),
                                 device=cuda)
    return tr, res, cap, host


@pytest.mark.parametrize("seam_backend", ["auto", "inline", "threaded"])
def test_compiled_offloaded_prefill_on_card(cuda, seam_backend):
    """A small offloading plan under the compiled backend: the same
    outputs as the interpreted run (within float32 rounding of the
    streaming sums) and the plain evaluation, every vertex accounted to
    one executor, the static part issued straight-line."""
    tr, res, cap, host = _tiny_prefill(cuda)
    assert res.n_offloads > 0 and res.n_reloads > 0
    plain = eval_taskgraph(tr.tg, host, device=cuda, plain=True)
    for policy, mode in RUNS:
        runs = {}
        for exec_backend in ("interpreted", "compiled"):
            rr = TurnipRuntime(tr.tg, res, backend="bytes", policy=policy,
                               mode=mode, seed=0, device=cuda,
                               capacities={d: cap for d in tr.tg.devices()},
                               exec_backend=exec_backend,
                               seam_backend=seam_backend).run(host)
            runs[exec_backend] = rr
        rc = runs["compiled"]
        assert rc.n_compiled > 0
        assert rc.n_compiled + rc.n_interpreted == len(res.memgraph)
        assert rc.n_inline + rc.n_threaded == rc.n_interpreted
        for tid, want in plain.items():
            torch.testing.assert_close(rc.outputs[tid], want, rtol=1e-4,
                                       atol=1e-5)
            torch.testing.assert_close(rc.outputs[tid],
                                       runs["interpreted"].outputs[tid],
                                       rtol=1e-4, atol=1e-5)


def test_causal_tile_is_complete_before_another_stream_reads_it(cuda,
                                                                monkeypatch):
    """The causal mask's shared tile is built on one stream and read on
    others: it is published only once its fill has finished. The building
    stream is held busy first, so a tile published before its fill would
    be read as the zeros of the block it reuses."""
    monkeypatch.setattr(port_ops, "_TRI", {})
    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    n = port_ops.MASK_BLOCK
    with torch.cuda.stream(a):
        junk = torch.zeros(n, n, dtype=torch.bool, device=cuda)
        del junk                      # its block is the tile's next
        torch.cuda._sleep(200_000_000)
        tri = port_ops._upper_tri(cuda)
    with torch.cuda.stream(b):
        seen = tri.clone()
    b.synchronize()
    want = torch.ones(n, n, dtype=torch.bool).triu_()
    assert torch.equal(seen.cpu(), want)


def test_compiled_causal_prefill_with_a_fresh_mask_tile(cuda, monkeypatch):
    """A process's first causal scores under the compiled backend: the
    first two scores vertices are static on two compute streams, the
    mask tile is not built yet, and the logits match the plain
    evaluation (run after, so it cannot build the tile first)."""
    monkeypatch.setattr(port_ops, "_TRI", {})
    tr, res, cap, host = _tiny_prefill(cuda, frac=1.0, n_devices=1)
    rt = TurnipRuntime(tr.tg, res, backend="bytes", policy="transfer-first",
                       seed=0, device=cuda, capacities={0: cap},
                       exec_backend="compiled")
    plan = lower(res, policy=rt.policy)
    mg = res.memgraph
    first = [ins for ins in plan.instrs
             if mg.vertices[ins.mid].op_name == "scores"][:2]
    assert all(plan.regions[ins.region].kind == STATIC for ins in first)
    assert first[0].stream != first[1].stream
    rr = rt.run(host)
    assert port_ops._TRI
    plain = eval_taskgraph(tr.tg, host, device=cuda, plain=True)
    for tid, want in plain.items():
        torch.testing.assert_close(rr.outputs[tid], want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_slow_kernels_keep_safe_overwrite_order_compiled(cuda, monkeypatch,
                                                         seed):
    """The compiled twin of the C1 test: every compute op first spins ~1 ms
    on its stream, and the static walker issues without waiting. Event
    waits on cross-stream predecessors (safe-overwrite edges included) and
    the seam handoff keep the outputs byte-exact under every policy."""
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
            for seam_backend in ("auto", "inline", "threaded"):
                rr = TurnipRuntime(tg, res, backend="bytes", policy=policy,
                                   mode=mode, seed=seed, device=cuda,
                                   capacities={d: cap * 64
                                               for d in tg.devices()},
                                   exec_backend="compiled",
                                   seam_backend=seam_backend).run(host)
                for tid, w in want.items():
                    assert torch.equal(rr.outputs[tid].cpu(), w)


def _reduce_graph(n_parts=8, shape=(2048, 2048)):
    """x -> y = copy(x) -> part i = scale(y, i + 1) -> streaming sum: the
    parts and the adds are not fed by a transfer, so they lower static."""
    tg = TaskGraph()
    x = tg.add_input(0, shape, name="x")
    y = tg.add_compute(0, (x,), shape, op="copy", name="y")
    parts = [tg.add_compute(0, (y,), shape, op="scale",
                            params={"alpha": float(i + 1)}, name=f"p{i}")
             for i in range(n_parts)]
    tg.add_reduce(0, parts, streaming=True, name="sum")
    return tg


def test_add_into_group_on_two_streams_stays_exact(cuda, monkeypatch):
    """A streaming sum whose ADD_INTO vertices the lowering spreads over
    two compute streams: each add waits on the previous add of its lock
    group, so no update is lost; the sum is exact (small integers in
    float32) and two compiled runs give the same bytes."""
    fn = port_ops.OPS["scale"]

    def slow(*xs, _fn=fn, **kw):
        torch.cuda._sleep(1_000_000)
        return _fn(*xs, **kw)
    monkeypatch.setitem(port_ops.OPS, "scale", slow)
    tg = _reduce_graph()
    res = build_memgraph(tg, BuildConfig(capacity=1 << 30))
    plan = lower(res, policy="fixed", n_streams=2)
    mg = res.memgraph
    adds = [ins for ins in plan.instrs
            if mg.vertices[ins.mid].op == MemOp.ADD_INTO]
    assert len(adds) >= 4
    assert all(plan.regions[ins.region].kind == STATIC for ins in adds)
    assert len({ins.stream for ins in adds}) == 2
    x = np.random.default_rng(0).integers(-3, 4, (2048, 2048)).astype(
        np.float32)
    host = inputs_from_reference({0: x}, device=cuda)
    want = torch.from_numpy(x) * sum(range(1, 9))
    outs = []
    for _ in range(2):
        rr = TurnipRuntime(tg, res, backend="bytes", policy="fixed",
                           n_streams=2, device=cuda,
                           capacities={0: 1 << 30},
                           exec_backend="compiled").run(host)
        out = next(iter(rr.outputs.values())).cpu()
        assert torch.equal(out, want)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


def test_seam_after_async_static_region_reads_its_last_write(cuda,
                                                             monkeypatch):
    """A static region of slow work (each op spins ~1 ms first) issued
    without host waits, then a nondet region whose first vertex reads the
    static region's last write: the handoff waits for that write, so the
    seam reads the finished value (the chain doubles a tensor 12 times;
    exact)."""
    fn = port_ops.OPS["scale"]

    def slow(*xs, _fn=fn, **kw):
        torch.cuda._sleep(1_000_000)
        return _fn(*xs, **kw)
    monkeypatch.setitem(port_ops.OPS, "scale", slow)
    shape = (1024, 1024)
    tg = TaskGraph()
    h = tg.add_input(0, shape, name="x")
    for i in range(12):
        h = tg.add_compute(0, (h,), shape, op="scale",
                           params={"alpha": 2.0}, name=f"c{i}")
    last = h
    tg.add_compute(0, (last, last), shape, op="add", name="seam")
    res = build_memgraph(tg, BuildConfig(capacity=1 << 31))
    rt = TurnipRuntime(tg, res, backend="bytes", policy="fixed",
                       device=cuda, capacities={0: 1 << 31},
                       exec_backend="compiled", seam_backend="inline")
    plan = lower(res, policy="fixed")
    mg = res.memgraph
    k = next(i for i, m in enumerate(plan.order)
             if mg.vertices[m].name == "seam")
    assert any(p == plan.order[k - 1] for p in mg.preds[plan.order[k]])
    plan.regions = [Region(STATIC, 0, k),
                    Region(NONDET, k, len(plan.order), "inline")]
    plan.instrs = [dataclasses.replace(ins, region=int(ins.pos >= k))
                   for ins in plan.instrs]
    plan.verify(mg)
    rt._compiled = plan
    x = np.random.default_rng(0).integers(-3, 4, shape).astype(np.float32)
    host = inputs_from_reference({0: x}, device=cuda)
    rr = rt.run(host)
    assert rr.n_interpreted == len(plan.order) - k and rr.n_inline > 0
    out = next(iter(rr.outputs.values())).cpu()
    assert torch.equal(out, torch.from_numpy(x) * 8192)


def test_static_regions_issue_without_host_waits(cuda, monkeypatch):
    """An all-static compiled run waits on the host at its start and its
    end only: no event or stream synchronisation per vertex."""
    waits = {"event": 0, "device": 0}
    ev_sync = torch.cuda.Event.synchronize
    dev_sync = torch.cuda.synchronize

    def count_event(self):
        waits["event"] += 1
        return ev_sync(self)

    def count_device(*a, **k):
        waits["device"] += 1
        return dev_sync(*a, **k)
    tg = _reduce_graph(n_parts=4, shape=(256, 256))
    res = build_memgraph(tg, BuildConfig(capacity=1 << 26))
    plan = lower(res, policy="fixed")
    assert all(r.kind == STATIC for r in plan.regions[1:])
    x = np.ones((256, 256), np.float32)
    host = inputs_from_reference({0: x}, device=cuda)
    rt = TurnipRuntime(tg, res, backend="bytes", policy="fixed",
                       device=cuda, capacities={0: 1 << 26},
                       exec_backend="compiled", seam_backend="inline")
    rt.run(host)                               # lowers the plan
    monkeypatch.setattr(torch.cuda.Event, "synchronize", count_event)
    monkeypatch.setattr(torch.cuda, "synchronize", count_device)
    rr = rt.run(host)
    seam = sum(len(r) for r in plan.regions if r.kind == NONDET)
    assert rr.n_compiled == len(plan.order) - seam
    # the seam's own vertices wait for their events; the static ones never
    assert waits["event"] <= seam + len(rt._compiled.regions)
    assert waits["device"] == 2


@pytest.mark.parametrize("exec_backend", ["interpreted", "compiled"])
def test_busy_is_within_the_makespan(cuda, exec_backend):
    """busy and the timeline are host spans of the run: 0 < busy <=
    makespan, stall is the rest, every span inside [0, makespan]."""
    tr, res, cap, host = _tiny_prefill(cuda)
    rr = TurnipRuntime(tr.tg, res, backend="bytes", policy="random", seed=0,
                       device=cuda, capacities={d: cap
                                                for d in tr.tg.devices()},
                       exec_backend=exec_backend).run(host)
    for d, busy in rr.busy.items():
        assert 0 < busy <= rr.makespan
        assert abs(rr.stall[d] - (rr.makespan - busy)) < 1e-12
    assert len(rr.spans) == len(res.memgraph)
    for a, b, *_ in rr.timeline:
        assert -1e-3 <= a <= b <= rr.makespan + 1e-3


def test_placement_bound_on_a_small_plan(cuda):
    """ROADMAP C2 on the card: the HBM a run allocates beyond what it had
    is the arena, the returned outputs, at most one 4 MiB cuBLAS workspace
    per (thread, compute stream) pair of the run, and ops' row scratch."""
    tr, res, cap, host = _tiny_prefill(cuda, dtype="float16", frac=0.2)
    ws_pairs = 2 * 5 + 1                 # fleet, static walker, inline
    allowance = ws_pairs * 4 * 2**20 + 2**20
    for exec_backend in ("interpreted", "compiled"):
        for policy, mode in RUNS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            rr = TurnipRuntime(tr.tg, res, backend="bytes", policy=policy,
                               mode=mode, seed=0, device=cuda,
                               capacities={d: cap for d in tr.tg.devices()},
                               exec_backend=exec_backend).run(host)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            outs = sum(t.numel() * t.element_size()
                       for t in rr.outputs.values() if t.is_cuda)
            assert peak <= rr.arena_bytes + outs + allowance, \
                (exec_backend, policy, mode, peak, rr.arena_bytes, outs)


# --------------------------------------------------------------------------
# training: the backward kernels and the model's gradients on the card
# --------------------------------------------------------------------------
# (B, Sq, Skv, Hq, Hkv, Dh, causal, q_offset): tests/test_kernels.py's
# attention sweep, two q_offset chunks, head size 112, GQA 4
BWD_SWEEP = [(2, 128, 128, 4, 2, 64, True, 0), (1, 200, 200, 4, 4, 128, True, 0),
             (2, 64, 256, 8, 2, 64, False, 0), (1, 256, 64, 2, 1, 64, True, 0),
             (1, 64, 256, 4, 2, 32, True, 192), (1, 100, 130, 4, 4, 112, True, 30),
             (1, 512, 512, 32, 8, 128, True, 0)]


@pytest.mark.parametrize("shape", [(7, 128), (3, 33, 256), (1, 512),
                                   (4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_rmsnorm_bwd_matches_plain_on_card(cuda, shape, dtype):
    """dx within one ulp of the storage type (KERNEL_TOL); dγ, a sum over
    the rows in another order, within KERNEL_TOL plus 2e-6 of the sum of
    its terms' magnitudes; the same bytes on a second call (no atomics)."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd, rmsnorm_bwd_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dy = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    g = torch.randn(shape[-1:], generator=gen, device=cuda).to(dtype)
    rtol, atol = KERNEL_TOL[dtype]
    before = rmsnorm_bwd.launches, rmsnorm_bwd.kernel_launches
    dx, dg = rmsnorm_bwd(x, g, dy)
    dx0, none = rmsnorm_bwd(x, g, dy, need_dg=False)
    assert none is None
    # two calls; three device launches (dγ's reduction is the third)
    assert (rmsnorm_bwd.launches, rmsnorm_bwd.kernel_launches) == \
        (before[0] + 2, before[1] + 3)
    pdx, pdg = rmsnorm_bwd_plain(x, g, dy)
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=rtol, atol=atol)
    assert torch.equal(dx, dx0)
    xf = x.float()
    terms = (dy.float() * xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                           + 1e-6)).reshape(-1, shape[-1])
    lim = atol + rtol * pdg.float().abs() + 2e-6 * terms.abs().sum(0)
    assert bool(((dg.float() - pdg.float()).abs() <= lim).all())
    assert torch.equal(rmsnorm_bwd(x, g, dy)[1], dg)


@pytest.mark.parametrize("case", BWD_SWEEP, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_bwd_matches_plain_on_card(cuda, case, dtype):
    """dQ, dK, dV within ``gradient_limit`` of the plain version (which
    computes its own log-sum-exp), the forward's lse within 1e-5 of the
    plain one, and the same bytes on a second call."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, gradient_limit,
        lse_plain)
    B, Sq, Skv, Hq, Hkv, Dh, causal, off = case
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(B, Sq, Hq, Dh, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Skv, Hkv, Dh, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lse = torch.empty(B, Hq, Sq, device=cuda)
    o = flash_attention(q, k, v, causal=causal, q_offset=off, lse=lse)
    assert (lse - lse_plain(q, k, causal, off)).abs().max() < 1e-5
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                              q_offset=off)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                     q_offset=off)
    name = str(dtype).removeprefix("torch.")
    for a, b in zip(got, want):
        assert bool(((a.float() - b.float()).abs()
                     <= gradient_limit(b, name)).all())
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                q_offset=off)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_bwd_is_deterministic_on_card(cuda, dtype):
    """Two calls on the same inputs give the same bytes (each output
    element is summed by one thread in a fixed order; no atomics), at a
    causal GQA shape with ragged tiles and q_offset; each call is two
    device launches on the 16-bit wgmma instance."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    B, Sq, Skv, Hq, Hkv, Dh, off = 2, 700, 764, 16, 4, 128, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn(B, Sq, Hq, Dh, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Skv, Hkv, Dh, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lse = torch.empty(B, Hq, Sq, device=cuda)
    o = flash_attention(q, k, v, q_offset=off, lse=lse)
    fb = flash_attention_bwd
    before = (fb.launches, fb.launches_tc, fb.kernel_launches)
    first = flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
    second = flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
    torch.cuda.synchronize()
    assert (fb.launches, fb.launches_tc, fb.kernel_launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 4)
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_silent_gradient_loss_on_card(cuda, dtype):
    """After one loss.backward() on a tiny llama-shaped model on the card,
    every parameter has a finite, nonzero gradient: the kernels' outputs
    carry a grad_fn, so nothing below the final norm is cut off; and the
    backward went through both backward kernels."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
    cfg = dataclasses.replace(reduced(get_arch("llama-7b")), dtype=dtype)
    model = build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    flat = []

    def mark(tree):
        for v in tree.values():
            if isinstance(v, dict):
                mark(v)
            else:
                flat.append(v.requires_grad_())
    mark(params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 65))
    n_rms, n_fa = rmsnorm_bwd.launches, flash_attention_bwd.launches
    loss = model.loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert loss.grad_fn is not None
    loss.backward()
    for t in flat:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().max()) > 0
    assert rmsnorm_bwd.launches - n_rms == 2 * cfg.n_layers + 1
    assert flash_attention_bwd.launches - n_fa == cfg.n_layers


# ------------------------------------------------------------------ C14
# (family, arch, the wrapper whose forward must launch, its launches per
# forward)
C14_FAMILIES = [("moe", "moonshot-v1-16b-a3b", "moe_gmm", 3),
                ("zamba", "zamba2-7b", "ssd_scan", 1),
                ("rwkv", "rwkv6-7b", "wkv6", 1)]


def _all_plain(monkeypatch):
    """Every kernel of the decoder families swapped for its plain,
    differentiable torch version: rmsnorm, attention, the grouped matmul,
    the SSD scan and WKV6."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_plain
    from repro_torch.models import layers as PL
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as SSM

    kernel_rms = PL.rmsnorm

    def rms(x, gamma, eps=1e-6):
        if gamma is None:                    # plain torch already
            return kernel_rms(x, None, eps)
        return rmsnorm_plain(x, gamma, eps=eps)

    def attn(q, k, v, *, causal, q_offset=0, block_kv=1024):
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    monkeypatch.setattr(PL, "rmsnorm", rms)
    monkeypatch.setattr(PL, "blockwise_attention", attn)
    monkeypatch.setattr(PL, "grouped_matmul",
                        lambda x, w, off, cnt, rows=None:
                        grouped_matmul_plain(x, w, off, cnt))
    monkeypatch.setattr(SSM, "ssd_scan", ssd_scan_plain)
    monkeypatch.setattr(R, "wkv6", wkv6_plain)


def _require_grads(tree: dict) -> None:
    for v in tree.values():
        if isinstance(v, dict):
            _require_grads(v)
        else:
            v.requires_grad_()


def _flat_grads(params) -> dict:
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = v.grad
    walk(params, "")
    return out


@pytest.mark.parametrize("family,arch,kernel,per_layer", C14_FAMILIES,
                         ids=[f[0] for f in C14_FAMILIES])
def test_family_trains_on_card_kernel_forward_and_backward(
        cuda, monkeypatch, family, arch, kernel, per_layer):
    """ROADMAP C14: the gradient of ``LM.loss`` of a reduced model of each
    family, float32, with the family's kernel in the forward and its
    backward kernel in the backward, is within 1e-3 x max|plain| of the
    all-plain gradient, leaf by leaf (the two-dtype rule's float32
    instance); the loss within 1e-3; and the launch counters show that
    the forward ran the kernel and the backward the backward kernel, as
    many times (no remat), and the all-plain leg neither."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counter = {"moe_gmm": moe_gmm, "ssd_scan": ssd_scan,
               "wkv6": wkv6}[kernel]
    bwd_counter = {"moe_gmm": moe_gmm_bwd, "ssd_scan": ssd_scan_bwd,
                   "wkv6": wkv6_bwd}[kernel]
    cfg = reduced(get_arch(arch))
    assert cfg.family == family and cfg.dtype == "float32"
    model = build_model(cfg, device=cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 97))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for leg in ("kernels", "plain"):
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        _require_grads(params)
        with monkeypatch.context() as mp:
            if leg == "plain":
                _all_plain(mp)
            before = counter.launches
            loss = model.loss(params, batch)
            launched = counter.launches - before
            before = bwd_counter.launches
            loss.backward()
            launched_bwd = bwd_counter.launches - before
        torch.cuda.synchronize()
        out[leg] = (loss.item(), _flat_grads(params), launched, launched_bwd)
    assert out["kernels"][2] == out["kernels"][3] \
        == per_layer * cfg.n_layers > 0
    assert out["plain"][2] == out["plain"][3] == 0
    assert abs(out["kernels"][0] - out["plain"][0]) \
        <= 1e-3 * abs(out["plain"][0])
    worst = 0.0
    for name, want in out["plain"][1].items():
        got = out["kernels"][1][name]
        if want is None:
            assert got is None, name
            continue
        assert got is not None and bool(torch.isfinite(got).all()), name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= 1e-3 * scale, (name, err, scale)
    assert worst <= 1e-3


@pytest.mark.parametrize("arch", [f[1] for f in C14_FAMILIES],
                         ids=[f[0] for f in C14_FAMILIES])
def test_launch_train_reduced_on_card(cuda, tmp_path, arch):
    """``repro_torch.launch.train --reduced`` (parse_args, setup and run,
    as its main calls them) takes 8 steps of each family on the card: every
    loss finite, the last three below the first three on average."""
    from repro_torch.launch import train as T
    args = T.parse_args(["--arch", arch, "--reduced", "--device", "cuda",
                         "--steps", "8", "--batch", "4", "--seq", "64",
                         "--lr", "1e-2", "--save-every", "100",
                         "--ckpt-dir", str(tmp_path)])
    r = T.setup(args)
    _, report, losses = T.run(r, args, log=lambda s: None)
    assert report.steps_run == 8 and len(losses) == 8
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_fleet_kill_on_card_matches_naive(cuda):
    """A reduced llama-7b (float32) behind a 3-replica ``Router`` on the
    card, each worker on its own CUDA stream; replica-0 armed before any
    submit to die after 3 decode steps: every request completes with the
    port's ``naive_generate`` tokens on the card up to the first near tie
    (top-two logits within 2e-2 x max|logit|), one replica is killed and
    drained, no fleet thread is left, the surviving pools drain, and the
    closed fleet's device memory is freed: every KV cache a replica made
    is gone, and what stays allocated is one cuBLAS workspace (4 MiB,
    CUBLAS_WORKSPACE_CONFIG above) and at most one cuBLASLt workspace
    (1 MiB) for each replica's worker stream."""
    import threading
    import time
    import weakref
    from repro_torch.launch.mesh import FleetTopology
    from repro_torch.serve import Router
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("llama-7b"))
    model = build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(17, 40, 9)]
    scfg = ServeConfig(max_len=128, batch_buckets=(1, 2), block_size=16,
                       offload=True, hot_window=16, preempt_every=2, seed=7)
    want, margins = [], []
    for i, p in enumerate(prompts):
        rows = []
        want.append(naive_generate(
            model, params, p, max_new=12, max_len=128, rid=i, seed=7,
            on_emit=lambda pos, row, rows=rows: rows.append(row.copy())))
        margins.append(rows)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    caches = []               # every device KV cache leaf the fleet makes
    init_cache = model.init_cache

    def tracked_init_cache(*args, **kw):
        cache = init_cache(*args, **kw)
        caches.extend(weakref.ref(leaf) for leaf in cache.values())
        return cache
    model.init_cache = tracked_init_cache
    topo = FleetTopology(n_replicas=3, heartbeat_timeout_s=60.0,
                         host_bytes_per_replica=64 << 20)
    with Router(model, params, scfg, topology=topo) as router:
        router.replicas[0].engine.fault_after_steps = 3
        rids = [router.submit(p, max_new=12) for p in prompts]
        router.wait(rids, timeout=300)
        outs = [router.result(r) for r in rids]
        summ = router.summary()
        for rep in router.replicas:
            if rep.pool is not None and not rep.closed:
                deadline = time.monotonic() + 30
                while not rep.pool.drained and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert rep.pool.drained and \
                    rep.pool.peak_bytes <= rep.pool.capacity
    assert summ["replicas_killed"] == 1 and summ["completed"] == 9
    assert summ["migrations"] + summ["reprefills"] > 0
    for ref, got, rows in zip(want, outs, margins):
        assert len(got) == len(ref)
        ties = [j for j, r in enumerate(rows)
                if np.diff(np.sort(r[:cfg.vocab_size])[-2:])[0]
                < 2e-2 * np.abs(r[:cfg.vocab_size]).max()]
        first_tie = min(ties + [len(ref)])
        assert got[:first_tie] == ref[:first_tie], (ref, got)
    deadline = time.monotonic() + 10
    while any(t.name.startswith(("router-", "nic", "serve-dma-"))
              for t in threading.enumerate() if t.is_alive()):
        assert time.monotonic() < deadline, "fleet threads left"
        time.sleep(0.05)
    del router
    import gc
    gc.collect()
    assert len(caches) >= 3 and all(ref() is None for ref in caches), \
        "a closed replica's device KV cache is still referenced"
    assert torch.cuda.memory_allocated() <= base + 3 * (4 + 1) * 2**20


def test_offload_gradients_equal_full_remat_on_card(cuda):
    """A 2-layer llama-width model (bf16) under LoRA: remat='offload'
    (each layer's input through pinned host memory on the copy streams)
    gives byte for byte the loss and adapter gradients of remat='full',
    and moves each layer's input out and back once."""
    from repro_torch.models import offload
    from repro_torch.models.lora import lora_init, make_lora_loss
    from repro_torch.train.step import value_and_grad
    cfg = dataclasses.replace(get_arch("llama-7b"), n_layers=2)
    base = build_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    ad = lora_init(torch.Generator(device=cuda).manual_seed(1), base)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for v in ad.values():
        v["B"] = torch.randn(v["B"].shape, generator=gen, device=cuda) * 0.01
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, 257))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in ("full", "offload"):
        model = build_model(cfg, device=cuda, remat=remat)
        offload.reset_moved()
        out[remat] = value_and_grad(make_lora_loss(model, base), ad, batch)
        torch.cuda.synchronize()
    assert torch.equal(out["full"][0], out["offload"][0])
    for k in ad:
        for n in ("A", "B"):
            assert torch.equal(out["full"][1][k][n], out["offload"][1][k][n])
    nbytes = 2 * 256 * cfg.d_model * 2
    assert offload.moved == {"offloaded": nbytes, "reloaded": nbytes}


# ------------------------------------------------------------------ A12
# (arch, layers kept): seamless-m4t-large-v2 at full width with 2 encoder
# and 2 decoder layers, internvl2-26b at full width with 2 layers
A12_ARCHS = [("seamless-m4t-large-v2", 2), ("internvl2-26b", 2)]


def _a12_model(cuda, arch: str, n_layers: int, dtype: str, remat=None):
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype=dtype)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_decoder_layers=n_layers)
    return build_model(cfg, device=cuda, remat=remat)


def _a12_batch(cfg, seed: int = 0) -> dict:
    """64 text tokens and labels a row, two rows, with the frontend's
    input (numpy seed): 100 frame embeddings, or n_frontend_tokens vision
    embeddings, N(0, 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = rng.standard_normal(
            (2, 100, cfg.d_model)).astype(np.float32)
    else:
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _a12_apply(model, params, batch):
    toks = torch.as_tensor(batch["tokens"], device=model.device).long()
    if model.cfg.family == "encdec":
        return model.apply(params, toks,
                           encoder_embeds=batch["encoder_embeds"])
    return model.apply(params, toks, vision_embeds=batch["vision_embeds"])


def _a12_flash_per_forward(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.n_layers + 2 * cfg.n_decoder_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch,n_layers", A12_ARCHS,
                         ids=[a for a, _ in A12_ARCHS])
def test_a12_logits_match_all_plain_on_card(cuda, monkeypatch, arch,
                                            n_layers):
    """float32 logits of ``apply`` with the frontend's input, the kernels
    against every kernel swapped for its plain version (``_all_plain``):
    within 1e-4 x max|plain|; flash (and, internvl, rmsnorm) launched as
    many times as the forward has attentions (norms)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _a12_model(cuda, arch, n_layers, "float32")
    cfg = model.cfg
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = _a12_batch(cfg)
    with torch.no_grad():
        n_fa, n_rms = flash_attention.launches, rmsnorm.launches
        got = _a12_apply(model, params, batch)
        torch.cuda.synchronize()
        assert flash_attention.launches - n_fa == _a12_flash_per_forward(cfg)
        assert rmsnorm.launches - n_rms == (
            0 if cfg.norm != "rmsnorm" else 2 * cfg.n_layers + 1)
        with monkeypatch.context() as mp:
            _all_plain(mp)
            want = _a12_apply(model, params, batch)
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch,n_layers", A12_ARCHS,
                         ids=[a for a, _ in A12_ARCHS])
def test_a12_lora_grad_matches_all_plain_on_card(cuda, monkeypatch, arch,
                                                 n_layers):
    """float32 LoRA loss and every adapter gradient (B drawn 0.01 N(0, 1))
    with the kernels, forward and backward, against the all-plain run:
    the loss within 1e-3 (relative), each gradient within 1e-3 x its
    max|plain|; the flash backward launched once an attention."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.models.lora import lora_init, make_lora_loss
    from repro_torch.train.step import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _a12_model(cuda, arch, n_layers, "float32")
    base = model.init(torch.Generator(device=cuda).manual_seed(0))
    ad = lora_init(torch.Generator(device=cuda).manual_seed(1), base)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for v in ad.values():
        v["B"] = torch.randn(v["B"].shape, generator=gen, device=cuda) * 0.01
    batch = _a12_batch(model.cfg, seed=1)
    n_fa, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    loss, grads = value_and_grad(make_lora_loss(model, base), ad, batch)
    torch.cuda.synchronize()
    per = _a12_flash_per_forward(model.cfg)
    assert flash_attention.launches - n_fa == per
    assert flash_attention_bwd.launches - n_bwd == per
    with monkeypatch.context() as mp:
        _all_plain(mp)
        ploss, pgrads = value_and_grad(make_lora_loss(model, base), ad,
                                       batch)
    assert abs(loss.item() - ploss.item()) <= 1e-3 * abs(ploss.item())
    for k in ad:
        for n in ("A", "B"):
            got, want = grads[k][n], pgrads[k][n]
            assert bool(torch.isfinite(got).all()), (k, n)
            scale = float(want.abs().max())
            assert scale > 0, (k, n)
            assert float((got - want).abs().max()) <= 1e-3 * scale, (k, n)


def test_encdec_decode_step_is_byte_equal_on_card(cuda):
    """A bfloat16 ``decode_step`` of seamless-m4t-large-v2 (full width,
    2 + 2 layers) twice from the same cache: the same logits and cache,
    byte for byte; the cross-attention launched once a layer, on the
    tensor-core instance, with one query row."""
    model = _a12_model(cuda, "seamless-m4t-large-v2", 2, "bfloat16")
    cfg = model.cfg
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((4, 300, cfg.d_model)).astype(np.float32)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 1)),
                          device=cuda)
    out = []
    with torch.no_grad():
        enc = model.encode(params, emb)
        for _ in range(2):
            cache = model.init_cache(4, 8, 300)
            cache["enc_out"].copy_(enc)
            n_tc = flash_attention.launches_tc
            logits, cache = model.decode_step(params, cache, tok, 0)
            torch.cuda.synchronize()
            assert flash_attention.launches_tc - n_tc == cfg.n_decoder_layers
            out.append((logits, cache))
    (l0, c0), (l1, c1) = out
    assert bool(torch.isfinite(l0.float()).all())
    assert torch.equal(l0, l1)
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k


# ---------------------------------------------------------------------------
# the backward kernels (ROADMAP B5): moe_gmm_bwd, ssd_scan_bwd, wkv6_bwd
# ---------------------------------------------------------------------------
def _grads_close(got, want, tol, names) -> None:
    """Each gradient within atol x max|plain| + rtol x |plain| of the
    plain one: the forward's tolerance, scaled to the gradient's own
    largest value (chip_smoke.py's _bwd_check)."""
    atol, rtol = tol
    for name, g, w in zip(names, got, want):
        wf = w.float()
        scale = float(wf.abs().max())
        err = (g.float() - wf).abs()
        assert bool((err <= atol * scale + rtol * wf.abs()).all()), \
            (name, float(err.max()), scale)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_matches_plain_on_card(cuda, case, dtype):
    """ssd_scan_bwd against the plain backward (autograd through
    ssd_scan_plain) at SCAN_TOL scaled to each gradient; two calls byte
    for byte; one call and five device launches each."""
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(cuda, B, S, H, P, N, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype)
    before = (ssd_scan_bwd.launches, ssd_scan_bwd.kernel_launches)
    got = ssd_scan_bwd(*args, dy, chunk=chunk)
    again = ssd_scan_bwd(*args, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_scan_bwd.launches - before[0],
            ssd_scan_bwd.kernel_launches - before[1]) == (2, 10)
    assert _same(got, again)
    assert [g.dtype for g in got] == [t.dtype for t in args]
    _grads_close(got, ssd_scan_bwd_plain(*args, dy, chunk=chunk),
                 SCAN_TOL["ssd_scan"][dtype], ("dx", "ddt", "dA", "dB", "dC"))


@pytest.mark.parametrize("case", WKV_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_matches_plain_on_card(cuda, case, dtype):
    """wkv6_bwd against the plain backward (autograd through wkv6_plain)
    at SCAN_TOL scaled to each gradient; two calls byte for byte; one call
    and six device launches each."""
    B, S, H, P, chunk = case
    args = _wkv_inputs(cuda, B, S, H, P, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda).to(dtype)
    before = (wkv6_bwd.launches, wkv6_bwd.kernel_launches)
    got = wkv6_bwd(*args, dy, chunk=chunk)
    again = wkv6_bwd(*args, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert (wkv6_bwd.launches - before[0],
            wkv6_bwd.kernel_launches - before[1]) == (2, 12)
    assert _same(got, again)
    assert [g.dtype for g in got] == [t.dtype for t in args]
    _grads_close(got, wkv6_bwd_plain(*args, dy, chunk=chunk),
                 SCAN_TOL["wkv6"][dtype], ("dr", "dk", "dv", "dlw", "du"))


def test_ssd_scan_bwd_on_zamba_ranges_against_float64(cuda):
    """zamba2-7b's input ranges at S = 8192, chunk 128: each gradient's
    error against autograd through a float64 evaluation of the model's
    recurrence is at most twice the plain backward's (chip_smoke.py's
    ssd_bwd_model_range rule)."""
    from repro_torch.models.ssm import _ssd_chunked
    gen = torch.Generator(device=cuda).manual_seed(6)
    B, S, H, P, N = 1, 8192, 8, 64, 64
    x = torch.randn(B, S, H, P, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=cuda))
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    Bm = torch.randn(B, S, N, generator=gen, device=cuda)
    Cm = torch.randn(B, S, N, generator=gen, device=cuda)
    dy = torch.randn(B, S, H, P, generator=gen, device=cuda)
    args = (x, dt, A, Bm, Cm)
    got = ssd_scan_bwd(*args, dy, chunk=128)
    plain = ssd_scan_bwd_plain(*args, dy, chunk=128)
    leaves = [t.double().requires_grad_() for t in args]
    h0 = torch.zeros(B, H, P, N, dtype=torch.float64, device=cuda)
    y, _ = _ssd_chunked(*leaves, chunk=128, h0=h0)
    exact = torch.autograd.grad(y, leaves, dy.double())
    for name, g, p, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                             exact):
        err_k = float((g.double() - e).abs().max())
        err_p = float((p.double() - e).abs().max())
        assert err_k <= 2 * err_p, (name, err_k, err_p)


def test_wkv6_bwd_on_the_models_decay_range(cuda):
    """rwkv6-7b's log decays, -exp(N(0, 2) - 6) clipped at -20 (rows at
    the clip included), at 1 x 4096 with 8 heads of 64, chunk 32: every
    gradient finite and within SCAN_TOL of the plain backward."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    r, k, v, dy = (torch.randn(1, 4096, 8, 64, generator=gen, device=cuda)
                   for _ in range(4))
    lw = (-torch.exp(torch.randn(1, 4096, 8, 64, generator=gen, device=cuda)
                     * 2.0 - 6.0)).clamp(-20, 0)
    lw[:, 5::97] = -20.0
    u = torch.randn(8, 64, generator=gen, device=cuda)
    got = wkv6_bwd(r, k, v, lw, u, dy, chunk=32)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _grads_close(got, wkv6_bwd_plain(r, k, v, lw, u, dy, chunk=32),
                 SCAN_TOL["wkv6"][torch.float32],
                 ("dr", "dk", "dv", "dlw", "du"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_bwd_ragged_groups_on_card(cuda, dtype):
    """moe_gmm_bwd on ragged groups with empty ones and rows in no group:
    dx and dw within gmm_tol (scaled to each gradient) of the plain
    backward, rows in no group dx = 0, an empty group's dw = 0; two calls
    byte for byte; the 16-bit call on the wgmma kernels, float32 on the
    scalar ones, two device launches each."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    R, D, F = 600, 96, 136
    x = torch.randn(R, D, generator=gen, device=cuda).to(dtype)
    w = torch.randn(5, D, F, generator=gen, device=cuda).to(dtype)
    dy = torch.randn(R, F, generator=gen, device=cuda).to(dtype)
    off = torch.tensor([3, 70, 70, 400, 599], dtype=torch.int32, device=cuda)
    cnt = torch.tensor([67, 0, 330, 1, 0], dtype=torch.int32, device=cuda)
    inst = "launches_wgmma" if dtype == torch.bfloat16 else "launches_scalar"
    before = {a: getattr(moe_gmm_bwd, a) for a in (
        "launches", "kernel_launches", "launches_wgmma", "launches_scalar")}
    got = moe_gmm_bwd(x, w, off, cnt, dy)
    again = moe_gmm_bwd(x, w, off, cnt, dy)
    torch.cuda.synchronize()
    after = {a: getattr(moe_gmm_bwd, a) - n for a, n in before.items()}
    assert after == {"launches": 2, "kernel_launches": 4, inst: 2,
                     ({"launches_wgmma", "launches_scalar"} - {inst}).pop(): 0}
    assert _same(got, again)
    rtol, atol = gmm_tol(dtype, 330)
    _grads_close(got, grouped_matmul_bwd_plain(x, w, off, cnt, dy),
                 (atol, rtol), ("dx", "dw"))
    outside = torch.ones(R, dtype=torch.bool, device=cuda)
    for o, c in ((3, 67), (70, 330), (400, 1)):
        outside[o:o + c] = False
    assert float(got[0][outside].abs().sum()) == 0.0
    assert float(got[1][1].abs().sum()) == float(got[1][4].abs().sum()) == 0


# (R, counts): one group of most rows and an empty one; the same with rows
# in no group between and after the groups
MOE_SKEWED = [(4096, [3000, 500, 0, 596]), (4200, [3001, 0, 600, 450])]


@pytest.mark.parametrize("case", range(len(MOE_SKEWED)))
def test_moe_gmm_bwd_skewed_group_on_card(cuda, case):
    """One group of most rows on the wgmma kernels, its dw one block's sum
    over the group's whole depth: dx and dw within gmm_tol of the plain
    backward, rows in no group zero, two calls byte for byte, two device
    launches a call."""
    R, cnts = MOE_SKEWED[case]
    D, F = 64, 64
    gen = torch.Generator(device=cuda).manual_seed(14 + case)
    offs, o = [], 0
    for c in cnts:                     # rows in no group after each group
        offs.append(o)
        o += c + (0 if case == 0 else 7)
    assert o <= R
    x = torch.randn(R, D, generator=gen, device=cuda).bfloat16()
    w = torch.randn(len(cnts), D, F, generator=gen, device=cuda).bfloat16()
    dy = torch.randn(R, F, generator=gen, device=cuda).bfloat16()
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    cnt = torch.tensor(cnts, dtype=torch.int32, device=cuda)
    before = (moe_gmm_bwd.launches, moe_gmm_bwd.kernel_launches)
    got = moe_gmm_bwd(x, w, off, cnt, dy)
    again = moe_gmm_bwd(x, w, off, cnt, dy)
    torch.cuda.synchronize()
    assert (moe_gmm_bwd.launches - before[0],
            moe_gmm_bwd.kernel_launches - before[1]) == (2, 4)
    assert _same(got, again)
    rtol, atol = gmm_tol(torch.bfloat16, max(cnts))
    _grads_close(got, grouped_matmul_bwd_plain(x, w, off, cnt, dy),
                 (atol, rtol), ("dx", "dw"))
    outside = torch.ones(R, dtype=torch.bool, device=cuda)
    for o, c in zip(offs, cnts):
        outside[o:o + c] = False
    assert float(got[0][outside].abs().sum()) == 0.0
    assert float(got[1][cnts.index(0)].abs().sum()) == 0.0


# (B, S, H, P, chunk): wkv6_bwd's anchors at chunks 8, 32 and 64, ragged
# last chunks
WKV_FACTORED = [(1, 3 * 8 + 5, 4, 64, 8), (2, 7 * 32 + 7, 4, 64, 32),
                (1, 5 * 64 + 9, 4, 32, 64)]


@pytest.mark.parametrize("case", WKV_FACTORED)
def test_wkv6_bwd_factored_on_the_models_decay_range(cuda, case):
    """wkv6_bwd's factored pair terms on rwkv6-7b's log decays (-exp(N(0,
    2) - 6) clipped at -20, rows at the clip): every gradient finite,
    within SCAN_TOL of the plain backward, two calls byte for byte."""
    B, S, H, P, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(15)
    r, k, v, dy = (torch.randn(B, S, H, P, generator=gen, device=cuda)
                   for _ in range(4))
    lw = (-torch.exp(torch.randn(B, S, H, P, generator=gen, device=cuda)
                     * 2.0 - 6.0)).clamp(-20, 0)
    lw[:, 3::11] = -20.0
    u = torch.randn(H, P, generator=gen, device=cuda)
    got = wkv6_bwd(r, k, v, lw, u, dy, chunk=chunk)
    again = wkv6_bwd(r, k, v, lw, u, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _same(got, again)
    _grads_close(got, wkv6_bwd_plain(r, k, v, lw, u, dy, chunk=chunk),
                 SCAN_TOL["wkv6"][torch.float32],
                 ("dr", "dk", "dv", "dlw", "du"))


@pytest.mark.parametrize("product", ["gate", "down"])
def test_moe_gmm_bwd_routed_on_wgmma(cuda, product):
    """The serving prefill's routed rows through moonshot's gate and down
    products in bfloat16: moe_gmm_bwd on the wgmma kernels, two calls byte
    for byte, dx and dw within gmm_tol of the plain backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, x, off, cnt = _moonshot_routed(cuda, 8 * 768, 3)
    K, N = (2048, 1408) if product == "gate" else (1408, 2048)
    x = torch.randn(x.shape[0], K, generator=gen, device=cuda).bfloat16()
    w = torch.randn(64, K, N, generator=gen, device=cuda).bfloat16()
    dy = torch.randn(x.shape[0], N, generator=gen, device=cuda).bfloat16()
    before = moe_gmm_bwd.launches_wgmma
    got = moe_gmm_bwd(x, w, off, cnt, dy)
    again = moe_gmm_bwd(x, w, off, cnt, dy)
    torch.cuda.synchronize()
    assert moe_gmm_bwd.launches_wgmma == before + 2
    assert _same(got, again)
    rtol, atol = gmm_tol(torch.bfloat16, K)
    _grads_close(got, grouped_matmul_bwd_plain(x, w, off, cnt, dy),
                 (atol, rtol), ("dx", "dw"))


def test_functions_never_run_plain_on_card_tensors(cuda, monkeypatch):
    """Under grad on CUDA tensors the three Functions launch the forward
    and the backward kernels; ``plain_grads`` and every plain version
    raise if reached."""
    from repro_torch.kernels import plain_grad
    from repro_torch.kernels.moe_gmm import ops as G
    from repro_torch.kernels.rwkv6 import ops as W
    from repro_torch.kernels.ssd_scan import ops as S

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for mod, names in ((plain_grad, ("plain_grads",)),
                       (G, ("plain_grads", "grouped_matmul_plain",
                            "grouped_matmul_bwd_plain", "moe_gmm_plain")),
                       (S, ("plain_grads", "ssd_scan_plain",
                            "ssd_scan_bwd_plain")),
                       (W, ("plain_grads", "wkv6_plain", "wkv6_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    gen = torch.Generator(device=cuda).manual_seed(13)

    def leaf(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype) \
            .requires_grad_()
    cases = [(G.grouped_matmul, G.moe_gmm_bwd,
              (leaf(40, 16, dtype=torch.bfloat16),
               leaf(4, 16, 24, dtype=torch.bfloat16)),
              (torch.arange(4, dtype=torch.int32, device=cuda) * 10,
               torch.full((4,), 10, dtype=torch.int32, device=cuda))),
             (S.ssd_scan, S.ssd_scan_bwd,
              (leaf(2, 50, 3, 8), leaf(2, 50, 3).abs().detach()
               .requires_grad_(), -leaf(3).abs().detach().requires_grad_(),
               leaf(2, 50, 4), leaf(2, 50, 4)), ()),
             (W.wkv6, W.wkv6_bwd,
              (leaf(2, 50, 3, 8), leaf(2, 50, 3, 8), leaf(2, 50, 3, 8),
               -leaf(2, 50, 3, 8).abs().detach().requires_grad_(),
               leaf(3, 8)), ())]
    for fwd, bwd, ins, rest in cases:
        counter = G.moe_gmm if fwd is G.grouped_matmul else fwd
        f0, b0 = counter.launches, bwd.launches
        y = fwd(*ins, *rest)
        grads = torch.autograd.grad(y, ins, torch.ones_like(y))
        torch.cuda.synchronize()
        assert (counter.launches - f0, bwd.launches - b0) == (1, 1)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
