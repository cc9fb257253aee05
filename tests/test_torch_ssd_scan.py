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
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd_scan(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))
