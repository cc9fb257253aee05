"""rmsnorm's backward in the port: the plain version of the backward
kernel (``rmsnorm_bwd_plain``) against ``jax.grad`` of the reference's
``layers.rmsnorm`` and of the Pallas kernel's ``ref.py``, on
``tests/test_kernels.py``'s rmsnorm sweep; ``RMSNormFn`` against
``torch.autograd.gradcheck`` in float64 and against autograd of the plain
forward; the wrapper's CPU path and its refusals. float32 tolerance:
rtol 1e-5, atol 1e-6 (both sides sum in f32, in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro.models import layers as RL
from repro_torch.kernels.rmsnorm.ops import (RMSNormFn, rmsnorm_bwd,
                                             rmsnorm_bwd_plain, rmsnorm_plain)
from repro_torch.models import layers as PL

SHAPES = [(7, 128), (3, 33, 256), (1, 512)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1:]).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("oracle", ["layers", "ref"])
def test_plain_backward_matches_jax_grad(shape, oracle):
    x, g, dy = _draw(shape, 0)
    fn = RL.rmsnorm if oracle == "layers" else rmsnorm_ref

    def f(xx, gg):
        return jnp.sum(fn(xx, gg) * dy)
    jdx, jdg = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    dx, dg = rmsnorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 8), (2, 3, 16)])
def test_function_gradcheck_float64(shape):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    g = torch.randn(shape[-1:], generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: RMSNormFn.apply(a, b, 1e-6), (x, g))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("need_g", [True, False])
def test_function_matches_autograd_of_plain(shape, need_g):
    x, g, dy = (torch.from_numpy(a) for a in _draw(shape, 1))
    xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_(need_g)
    y = RMSNormFn.apply(xa, ga, 1e-6)
    assert torch.equal(y, rmsnorm_plain(x, g))
    y.backward(dy)
    xb, gb = x.clone().requires_grad_(), g.clone().requires_grad_(need_g)
    rmsnorm_plain(xb, gb).backward(dy)
    torch.testing.assert_close(xa.grad, xb.grad, **TOL)
    if need_g:
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-5, atol=1e-5)
    else:
        assert ga.grad is None


def test_layer_goes_through_the_function():
    x, g, dy = (torch.from_numpy(a) for a in _draw((4, 64), 2))
    xa, ga = x.clone().requires_grad_(), g.clone().requires_grad_()
    y = PL.rmsnorm(xa, ga)
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"
    y.backward(dy)
    dx, dg = rmsnorm_bwd_plain(x, g, dy)
    assert torch.equal(xa.grad, dx) and torch.equal(ga.grad, dg)
    with torch.no_grad():                 # no gradient: the forward alone
        assert PL.rmsnorm(xa, ga).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    x, g, dy = (torch.from_numpy(a).to(dtype) for a in _draw((5, 32), 3))
    dx, dg = rmsnorm_bwd(x, g, dy)
    pdx, pdg = rmsnorm_bwd_plain(x, g, dy)
    assert dx.dtype == dtype and dg.dtype == dtype
    assert torch.equal(dx, pdx) and torch.equal(dg, pdg)
    out = torch.empty_like(x)
    dx2, none = rmsnorm_bwd(x, g, dy, need_dg=False, out=out)
    assert dx2 is out and none is None and torch.equal(out, pdx)


def test_wrapper_refuses_bad_inputs():
    x, g, dy = (torch.from_numpy(a) for a in _draw((5, 32), 4))
    with pytest.raises(TypeError):
        rmsnorm_bwd(x.double(), g.double(), dy.double())
    with pytest.raises(ValueError):
        rmsnorm_bwd(x, g[:16], dy)
    with pytest.raises(ValueError):
        rmsnorm_bwd(x, g, dy[:, :16])
    with pytest.raises(ValueError):
        rmsnorm_bwd(x, g, dy, out=torch.empty(5, 16))
