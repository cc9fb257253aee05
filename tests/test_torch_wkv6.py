"""The port's WKV6 (``repro_torch/kernels/rwkv6``) and the model's own
recurrence (``repro_torch/models/rwkv.py::wkv6_chunked``) on the CPU, where
the wrapper computes the plain version.

``wkv6`` and ``wkv6_plain`` against the reference's Pallas kernel in
interpret mode and its ``wkv6_ref`` (chunk 19, another chunking) on
``tests/test_kernels.py::TestWKV6``'s sweep, at that test's tolerance
(1e-3) in float32 and 3e-2 in bfloat16; ``lw`` clipped at -20 as there.
``wkv6_chunked`` with an incoming state against the reference's, output
and final state, at chunk 1, at a chunk that does not divide S, and at
S = 1 (2e-3, as ``tests/test_recurrences.py``); the two port
implementations against each other. The wrapper's refusals. The CUDA
kernel's design, its three passes with the anchored factors, emulated in
plain torch against the plain version, the Pallas kernel and ``wkv6_ref``
(1e-3) over three seeds, with every factor <= 1; and why its products are
not plain TF32. The CUDA kernel itself is held against ``wkv6_plain`` on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref
from repro.models.rwkv import wkv6_chunked as ref_wkv6_chunked
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_plain
from repro_torch.models.rwkv import wkv6_chunked

torch.set_num_threads(1)

SWEEP = [(2, 100, 3, 32, 25), (1, 31, 2, 64, 8),      # test_kernels.py
         (2, 64, 1, 16, 64)]
TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _inputs(B, S, H, P, dtype="float32", seed=0):
    """(JAX arrays, the same values as CPU tensors): r, k, v, lw, u."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, P)) for _ in range(3))
    lw = np.clip(-np.exp(rng.normal(size=(B, S, H, P))), -20, 0)
    u = rng.normal(size=(H, P))
    js = [jnp.asarray(a, dtype) for a in (r, k, v, lw)] \
        + [jnp.asarray(u, "float32")]
    return js, [host_tensor(np.asarray(a), pin=False) for a in js]


@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(B, S, H, P, chunk, dtype):
    js, ts = _inputs(B, S, H, P, dtype)
    kernel = np.asarray(pallas_wkv6(*js, chunk=chunk, interpret=True),
                        np.float32)
    ref = np.asarray(wkv6_ref(*(a.astype("float32") for a in js),
                              chunk=19), np.float32)
    for fn in (wkv6, wkv6_plain):
        got = fn(*ts, chunk=chunk)
        assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
        got = got.float().numpy()
        np.testing.assert_allclose(got, kernel, **TOL[dtype])
        np.testing.assert_allclose(got, ref, **TOL[dtype])


# (S, chunk): one step per chunk, a chunk that does not divide S, S = 1,
# one whole chunk
CHUNKED = [(20, 1), (50, 16), (1, 32), (40, 40)]


@pytest.mark.parametrize("S,chunk", CHUNKED)
def test_model_recurrence_matches_reference_with_state(S, chunk):
    js, ts = _inputs(2, S, 2, 8, seed=S)
    rng = np.random.default_rng(7)
    s0 = rng.normal(size=(2, 2, 8, 8)).astype(np.float32)
    y_ref, s_ref = ref_wkv6_chunked(*js, chunk=chunk, s0=jnp.asarray(s0))
    y, sT = wkv6_chunked(*ts, chunk=chunk, s0=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(sT.numpy(), np.asarray(s_ref), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,chunk", SWEEP)
def test_plain_matches_model_recurrence(B, S, H, P, chunk):
    """The kernel's plain version and the model's recurrence are two
    independent port implementations of one function."""
    _, ts = _inputs(B, S, H, P, seed=3)
    y, _ = wkv6_chunked(*ts, chunk=chunk)
    np.testing.assert_allclose(wkv6_plain(*ts, chunk=chunk).numpy(),
                               y.numpy(), **TOL["float32"])


def test_wrapper_is_the_plain_version_on_cpu():
    _, ts = _inputs(2, 70, 3, 16)
    before = wkv6.launches
    assert torch.equal(wkv6(*ts, chunk=32), wkv6_plain(*ts, chunk=32))
    assert wkv6.launches == before              # the CPU launches nothing


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, (r, k, v, lw, u) = _inputs(1, 8, 2, 4)
    with pytest.raises(TypeError):
        wkv6(r.int(), k, v, lw, u)
    with pytest.raises(TypeError, match="float16"):   # no float16 instance
        wkv6(r.half(), k.half(), v.half(), lw.half(), u)
    with pytest.raises(ValueError, match=r"\[B, S, H, P\]"):
        wkv6(r[0], k, v, lw, u)
    with pytest.raises(ValueError, match="lw must be"):
        wkv6(r, k, v, lw[:, :4], u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, k, v, lw, u, chunk=0)
    # a meta tensor holds shapes only: no launch, an empty output and the
    # kernel's counted work for the dry run (kernels/shape_only.py)
    from repro_torch.kernels.rwkv6.ops import wkv6_cost
    from repro_torch.kernels.shape_only import recording
    seen = []
    with recording(lambda *a: seen.append(a)):
        y = wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))
    assert y.device.type == "meta" and y.shape == r.shape
    assert seen == [("wkv6", *wkv6_cost(1, 8, 2, 4, 8, 4))]


# --- the CUDA kernel's design, emulated on the CPU -------------------------
# csrc/wkv6.cu computes the recurrence in three passes: each group of
# `group` chunks' own state, a pass across the groups that carries the
# state, then the outputs, each group walking its chunks from the state
# entering it. _passes is that decomposition in plain torch with the
# kernel's per-element formulas: per chunk lcw = cumsum(lw), prev_t =
# lcw_{t-1}; A outside the diagonal 8 x 8 blocks through the anchored
# factors (r rescaled to the start of its sub-block, k to the end of its
# own, and a per-(sub-block pair, channel) factor between them); per-pair
# exponentials inside the diagonal blocks; the bonus on A's diagonal.
# Every exponent's argument is collected so that a test can hold each
# factor to <= 1. `mm` is each product the tensor cores could take (y's
# r exp(prev) S and A v, the state update's (k tail)^T v), so that the
# roundings the kernel does not use can be held to the same rule: TF32
# (operands rounded once to 10 mantissa bits) and 3xTF32 (lo.hi + hi.lo +
# hi.hi).

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero (cvt.rna)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def _mm_tf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def _passes(r, k, v, lw, u, *, chunk, group, mm=torch.matmul):
    """(y in r.dtype, every exponent's argument as one flat f32 tensor)."""
    B, S, H, P = r.shape
    c = min(chunk, S)
    nc = -(-S // c)
    nsb = -(-c // 8)
    rows = 8 * nsb                  # the kernel's tile rows (zero past c)

    def chunks(t):                  # [B, S, H, P] -> [B, H, nc, rows, P] f32
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, nc * c - S))
        t = t.reshape(B, nc, c, H, P).permute(0, 3, 1, 2, 4)
        return torch.nn.functional.pad(t, (0, 0, 0, rows - c))

    rf, kf, vf, lwf = (chunks(t) for t in (r, k, v, lw))
    uf = u.float()[None, :, None, None, :]
    lcw = torch.cumsum(lwf, dim=3)
    prev = torch.nn.functional.pad(lcw, (0, 0, 1, 0))[..., :-1, :]
    last = lcw[..., -1:, :]
    sb = torch.arange(rows) // 8
    start = prev[..., ::8, :]                       # lcw before sub-block a
    fin = lcw[..., 7::8, :]                         # lcw after sub-block b
    args = []

    def ex(x):
        args.append(x.reshape(-1))
        return torch.exp(x)

    rh = rf * ex(prev - start[..., sb, :])
    kh = kf * ex(fin[..., sb, :] - lcw)
    A = torch.zeros(B, H, nc, rows, rows)
    t_i, s_i = (sb[:, None] > sb[None, :]).nonzero(as_tuple=True)
    if len(t_i):                                    # off the diagonal blocks
        m = ex(start[..., sb[t_i], :] - fin[..., sb[s_i], :])
        A[..., t_i, s_i] = (rh[..., t_i, :] * m * kh[..., s_i, :]).sum(-1)
    inside = (sb[:, None] == sb[None, :]) & (torch.arange(rows)[:, None]
                                             > torch.arange(rows)[None, :])
    t_i, s_i = inside.nonzero(as_tuple=True)
    if len(t_i):
        e = ex(prev[..., t_i, :] - lcw[..., s_i, :])
        A[..., t_i, s_i] = (rf[..., t_i, :] * e * kf[..., s_i, :]).sum(-1)
    diag = torch.arange(rows)
    A[..., diag, diag] = (rf * uf * kf).sum(-1)
    r_e = rf * ex(prev)
    kt = kf * ex(last - lcw)
    d = ex(last)[..., 0, :, None]                   # [B, H, nc, P, 1]
    U = mm(kt.transpose(-1, -2), vf)                # [B, H, nc, P, P]
    # pass 1: each group's own state and decay
    starts = list(range(0, nc, group))
    own, dec = [], []
    for g0 in starts:
        s_g = torch.zeros(B, H, P, P)
        d_g = torch.ones(B, H, P, 1)
        for i in range(g0, min(g0 + group, nc)):
            s_g = d[:, :, i] * s_g + U[:, :, i]
            d_g = d_g * d[:, :, i]
        own.append(s_g)
        dec.append(d_g)
    # pass 2: the state entering each group
    h = torch.zeros(B, H, P, P)
    entering = []
    for s_g, d_g in zip(own, dec):
        entering.append(h)
        h = d_g * h + s_g
    # pass 3: the outputs, each group from its entering state
    ys = []
    for g0, s in zip(starts, entering):
        for i in range(g0, min(g0 + group, nc)):
            ys.append(mm(r_e[:, :, i], s) + mm(A[:, :, i], vf[:, :, i]))
            s = d[:, :, i] * s + U[:, :, i]
    y = torch.stack(ys, 2)[..., :c, :]              # [B, H, nc, c, P]
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * c, H, P)[:, :S]
    return y.to(r.dtype), torch.cat(args)


def _design_inputs(B, S, H, P, kind, seed):
    """The test sweep's ranges (``sweep``), the model's decay range
    -exp(N(0, 2) - 6) (``model``), or the sweep's with every fifth row's
    decay at the clip, lw = -20 (``floor``)."""
    js, ts = _inputs(B, S, H, P, seed=seed)
    if kind == "sweep":
        return js, ts
    rng = np.random.default_rng(100 + seed)
    lw = np.asarray(js[3])
    if kind == "model":
        lw = np.clip(-np.exp(rng.normal(size=lw.shape) * 2.0 - 6.0), -20, 0)
    else:
        lw = lw.copy()
        lw[:, 3::5] = -20.0
    js[3] = jnp.asarray(lw, "float32")
    ts[3] = host_tensor(np.asarray(js[3]), pin=False)
    return js, ts


# (B, S, H, P, chunk, kind): the test sweep; the model's decays at two
# chunks, a length that is no multiple of 4 chunks and one of 19 chunks
# (two groups of 16, the wrapper's); rows at lw = -20; S below one chunk
DESIGN_CASES = [(*shape, "sweep") for shape in SWEEP] + [
    (1, 300, 2, 64, 32, "model"), (2, 167, 2, 32, 16, "model"),
    (1, 600, 2, 16, 32, "model"), (1, 200, 2, 64, 32, "floor"),
    (2, 20, 3, 16, 32, "sweep")]


@functools.lru_cache(maxsize=None)
def _design_references(B, S, H, P, chunk, kind, seed):
    """The plain version, the Pallas kernel in interpret mode and wkv6_ref
    (chunk 19) on one design case, shared by its groups."""
    js, ts = _design_inputs(B, S, H, P, kind, seed)
    return (wkv6_plain(*ts, chunk=chunk).numpy(),
            np.asarray(pallas_wkv6(*js, chunk=chunk, interpret=True),
                       np.float32),
            np.asarray(wkv6_ref(*js, chunk=19), np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("B,S,H,P,chunk,kind", DESIGN_CASES)
def test_passes_match_plain_pallas_and_ref(B, S, H, P, chunk, kind, group,
                                           seed):
    """The kernel's three passes, in f32 torch on the CPU, against the plain
    version, the Pallas kernel in interpret mode and wkv6_ref at the float32
    rule; every factor the passes form is <= 1 and every output finite."""
    _, ts = _design_inputs(B, S, H, P, kind, seed)
    got, args = _passes(*ts, chunk=chunk, group=group)
    assert got.dtype == torch.float32 and got.shape == ts[0].shape
    assert bool(torch.isfinite(got).all())
    assert float(args.max()) <= 0.0            # each factor exp(.) <= 1
    got = got.numpy()
    for want in _design_references(B, S, H, P, chunk, kind, seed):
        np.testing.assert_allclose(got, want, **TOL["float32"])


def _over_limit(got, want, rtol=1e-3, atol=1e-3) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails the rule."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("kind", ["sweep", "model"])
def test_tf32_products_fail_the_rule_and_3xtf32_passes(kind):
    """Why the kernel's products are not plain TF32: rounded once they
    miss the float32 rule against the plain version by far (the state sums
    hundreds of rows); split as 3xTF32 they keep it, as the kernel's f32
    FMAs do."""
    _, ts = _design_inputs(1, 1024, 4, 64, kind, seed=0)
    plain = wkv6_plain(*ts, chunk=32).numpy()

    def over(mm):
        return _over_limit(_passes(*ts, chunk=32, group=4, mm=mm)[0], plain)
    once, split, full = over(_mm_tf32), over(_mm_3xtf32), over(torch.matmul)
    assert once > 5.0, once
    assert split <= 1.0 and full <= 1.0, (split, full)
