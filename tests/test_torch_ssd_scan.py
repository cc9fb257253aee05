"""The port's SSD scan (``repro_torch/kernels/ssd_scan``) and the model's own
recurrence (``repro_torch/models/ssm.py::_ssd_chunked``) on the CPU, where
the wrapper computes the plain version.

``ssd_scan`` and ``ssd_scan_plain`` against the reference's Pallas kernel
in interpret mode and its ``ssd_scan_ref`` (chunk 37, another chunking) on
``tests/test_kernels.py::TestSSDScan``'s sweep, at that test's tolerance
(5e-4) in float32 and 3e-2 in bfloat16. ``_ssd_chunked`` with an incoming
state against the reference's, output and final state, at chunk 1, at a
chunk that does not divide S, and at S = 1 (2e-3, as
``tests/test_recurrences.py``); the two port implementations against each
other. The wrapper's refusals. The CUDA kernel itself is held against
``ssd_scan_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models.ssm import _ssd_chunked as ref_ssd_chunked
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.models.ssm import _ssd_chunked

torch.set_num_threads(1)

SWEEP = [(2, 100, 3, 32, 16, 32), (1, 64, 2, 64, 64, 16),   # test_kernels.py
         (2, 33, 1, 16, 8, 64)]
TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _inputs(B, S, H, P, N, dtype="float32", seed=0):
    """(JAX arrays, the same values as CPU tensors): xh, dt, A, Bm, Cm."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, H, P)), np.abs(rng.normal(size=(B, S, H))),
            -np.abs(rng.normal(size=(H,))), rng.normal(size=(B, S, N)),
            rng.normal(size=(B, S, N))]
    js = [jnp.asarray(a, dtype if i != 2 else "float32")
          for i, a in enumerate(arrs)]
    return js, [host_tensor(np.asarray(a), pin=False) for a in js]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(B, S, H, P, N, chunk, dtype):
    js, ts = _inputs(B, S, H, P, N, dtype)
    kernel = np.asarray(pallas_ssd_scan(*js, chunk=chunk, interpret=True),
                        np.float32)
    ref = np.asarray(ssd_scan_ref(*(a.astype("float32") for a in js),
                                  chunk=37), np.float32)
    for fn in (ssd_scan, ssd_scan_plain):
        got = fn(*ts, chunk=chunk)
        assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
        got = got.float().numpy()
        np.testing.assert_allclose(got, kernel, **TOL[dtype])
        np.testing.assert_allclose(got, ref, **TOL[dtype])


# (S, chunk): one step per chunk, a chunk that does not divide S, S = 1,
# one whole chunk
CHUNKED = [(20, 1), (50, 16), (1, 128), (64, 64)]


@pytest.mark.parametrize("S,chunk", CHUNKED)
def test_model_recurrence_matches_reference_with_state(S, chunk):
    js, ts = _inputs(2, S, 2, 8, 5, seed=S)
    rng = np.random.default_rng(7)
    h0 = rng.normal(size=(2, 2, 8, 5)).astype(np.float32)
    y_ref, h_ref = ref_ssd_chunked(*js, chunk=chunk, h0=jnp.asarray(h0))
    y, hT = _ssd_chunked(*ts, chunk=chunk, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_ref), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_plain_matches_model_recurrence(B, S, H, P, N, chunk):
    """The kernel's plain version and the model's recurrence are two
    independent port implementations of one function."""
    _, ts = _inputs(B, S, H, P, N, seed=3)
    y, _ = _ssd_chunked(*ts, chunk=chunk)
    np.testing.assert_allclose(ssd_scan_plain(*ts, chunk=chunk).numpy(),
                               y.numpy(), **TOL["float32"])


def test_wrapper_is_the_plain_version_on_cpu():
    _, ts = _inputs(2, 70, 3, 16, 8)
    before = ssd_scan.launches
    assert torch.equal(ssd_scan(*ts, chunk=32),
                       ssd_scan_plain(*ts, chunk=32))
    assert ssd_scan.launches == before          # the CPU launches nothing


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, (x, dt, A, Bm, Cm) = _inputs(1, 8, 2, 4, 3)
    with pytest.raises(TypeError):
        ssd_scan(x.int(), dt, A, Bm, Cm)
    with pytest.raises(TypeError, match="float16"):   # no float16 instance
        ssd_scan(x.half(), dt.half(), A, Bm.half(), Cm.half())
    with pytest.raises(ValueError, match=r"\[B, S, H, P\]"):
        ssd_scan(x[0], dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan(x, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="A must be"):
        ssd_scan(x, dt, A[:1], Bm, Cm)
    with pytest.raises(ValueError, match="Cm must be"):
        ssd_scan(x, dt, A, Bm, Cm[..., :2])
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=0)
    # a meta tensor holds shapes only: no launch, an empty output and the
    # kernel's counted work for the dry run (kernels/shape_only.py)
    from repro_torch.kernels.shape_only import recording
    from repro_torch.kernels.ssd_scan.ops import ssd_cost
    seen = []
    with recording(lambda *a: seen.append(a)):
        y = ssd_scan(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))
    assert y.device.type == "meta" and y.shape == x.shape
    assert seen == [("ssd_scan", *ssd_cost(1, 8, 2, 4, 3, 8, 4))]


# --- the CUDA kernel's design, emulated on the CPU -------------------------
# csrc/ssd_scan.cu computes the scan in three passes: each chunk's own
# state, a pass across the chunks that carries the state, then the outputs.
# _three_pass is that decomposition in plain torch with the kernel's
# per-element formulas (seg summed in f64, each exponent's difference taken
# in f64 and rounded to f32); `mm` is every chunk product, so that the
# tensor-core roundings the kernel does not use can be held to the same
# rule: TF32 (operands rounded once to 10 mantissa bits) and 3xTF32
# (hi.hi + hi.lo + lo.hi).

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm_tf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah, bh)


def _three_pass(xh, dt, A, Bm, Cm, *, chunk, mm=torch.matmul):
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S

    def chunks(t):                      # [B, S, ...] -> [B, nc, c, ...], f32
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B, nc, c, *t.shape[2:])

    x, d, Bf, Cf = chunks(xh), chunks(dt), chunks(Bm), chunks(Cm)
    seg = torch.cumsum((d * A.float()).double(), dim=2)      # [B,nc,c,H]
    last = seg[:, :, -1:]
    # pass 1: S_c = sum_s (x_s * tail_s) B_s^T, and exp(seg_last)
    tail = torch.exp((last - seg).float()) * d
    xt = (x * tail[..., None]).permute(0, 1, 3, 4, 2)        # [B,nc,H,P,c]
    own = mm(xt, Bf[:, :, None])                              # [B,nc,H,P,N]
    decay = torch.exp(last[:, :, 0].float())[..., None, None]  # [B,nc,H,1,1]
    # pass 2: the state entering each chunk
    h = torch.zeros(B, H, P, N)
    entering = []
    for i in range(nc):
        entering.append(h)
        h = decay[:, i] * h + own[:, i]
    hin = torch.stack(entering, 1)                            # [B,nc,H,P,N]
    # pass 3: y = W x + (C h^T) exp(seg), W = (C.B^T * decay) * dt
    cb = mm(Cf, Bf.transpose(-1, -2))                         # [B,nc,t,s]
    diff = (seg[:, :, :, None] - seg[:, :, None]).float()     # [B,nc,t,s,H]
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool))[..., None]
    w = cb[..., None] * torch.exp(diff.masked_fill(~tri, -1e30)) \
        * d[:, :, None]
    y = mm(w.permute(0, 1, 4, 2, 3), x.permute(0, 1, 3, 2, 4))  # [B,nc,H,t,P]
    ch = mm(Cf[:, :, None], hin.transpose(-1, -2))            # [B,nc,H,c,P]
    y = y + ch * torch.exp(seg.float()).permute(0, 1, 3, 2)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * c, H, P)[:, :S]
    return y.to(xh.dtype)


def _over_limit(got, want, rtol=5e-4, atol=5e-4) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 fails the rule."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


DESIGN_CASES = SWEEP + [(1, 1024, 4, 64, 64, 128)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,S,H,P,N,chunk", DESIGN_CASES)
def test_three_pass_decomposition_matches_plain_and_ref(B, S, H, P, N, chunk,
                                                        seed):
    """The kernel's three passes, in f32 torch on the CPU, against the plain
    version and the reference's ssd_scan_ref at the float32 rule, on the
    reference test's input ranges."""
    js, ts = _inputs(B, S, H, P, N, seed=seed)
    got = _three_pass(*ts, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ts[0].shape
    ref = np.asarray(ssd_scan_ref(*js, chunk=37), np.float32)
    np.testing.assert_allclose(got.numpy(), ssd_scan_plain(
        *ts, chunk=chunk).numpy(), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), ref, **TOL["float32"])


def test_tf32_chunk_products_fail_the_rule_and_3xtf32_passes():
    """Why the kernel's chunk products are not plain TF32: rounded once,
    they miss the float32 rule against the plain version by far; split as
    3xTF32 they keep it, as f32 FMAs do."""
    _, ts = _inputs(1, 1024, 4, 64, 64, seed=0)
    plain = ssd_scan_plain(*ts, chunk=128).numpy()
    once = _over_limit(_three_pass(*ts, chunk=128, mm=_mm_tf32), plain)
    split = _over_limit(_three_pass(*ts, chunk=128, mm=_mm_3xtf32), plain)
    full = _over_limit(_three_pass(*ts, chunk=128), plain)
    assert once > 5.0, once
    assert split <= 1.0 and full <= 1.0, (split, full)
