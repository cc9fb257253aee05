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
kernel itself is held against ``wkv6_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
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
    with pytest.raises(ValueError, match="no kernel for device"):
        wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))
