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
from repro_torch.kernels.flash_attention.ops import (attention_limit,
                                                     flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.moe_gmm.ops import (grouped_matmul,
                                             grouped_matmul_plain, moe_gmm,
                                             moe_gmm_plain)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_plain
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
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
