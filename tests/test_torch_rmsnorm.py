"""The rmsnorm kernel's wrapper and plain version.

``rmsnorm_plain`` is held against the JAX Pallas kernel, run as
``tests/test_kernels.py`` runs it (interpret mode, 16-row blocks), and
against ``rmsnorm_ref``, at the same shapes and tolerances. On a CPU
tensor the wrapper computes the plain version and launches nothing; the
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.core import lockcheck
from repro_torch.core.bridge import host_tensor
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain

# tiny tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

SHAPES = [(7, 128), (3, 33, 256), (1, 512)]


def _tol(dtype):                      # tests/test_kernels.py's tolerances
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _inputs(shape, dtype, seed=42):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=shape), dtype)
    g = jnp.asarray(rng.normal(size=shape[-1:]), dtype)
    # the same values for the port, through the bridge (bf16 by dtype name)
    return x, g, host_tensor(np.asarray(x), pin=False), \
        host_tensor(np.asarray(g), pin=False)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(shape, dtype):
    x, g, tx, tg = _inputs(shape, dtype)
    got = rmsnorm_plain(tx, tg).float().numpy()
    kernel = pallas_rmsnorm(x, g, interpret=True, block_rows=16)
    np.testing.assert_allclose(got, np.asarray(kernel, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(got, np.asarray(rmsnorm_ref(x, g), np.float32),
                               **_tol(dtype))
    assert str(rmsnorm_plain(tx, tg).dtype) == f"torch.{dtype}"


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_takes_the_plain_path(shape):
    _, _, x, g = _inputs(shape, "float32")
    rmsnorm.launches = 0
    y = rmsnorm(x, g)
    assert torch.equal(y, rmsnorm_plain(x, g))
    out = torch.empty_like(x)
    assert rmsnorm(x, g, out=out) is out
    assert torch.equal(out, y)
    assert rmsnorm.launches == 0


def test_wrapper_checks_its_arguments():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError):
        rmsnorm(x, torch.randn(7))                       # wrong width
    with pytest.raises(ValueError):
        rmsnorm(x, torch.randn(8, dtype=torch.float64))  # dtype mismatch
    with pytest.raises(ValueError):
        rmsnorm(x, torch.randn(8), out=torch.empty(4, 8, dtype=torch.float16))
    with pytest.raises(TypeError):
        rmsnorm(x.to(torch.int32), torch.randn(8).to(torch.int32))

