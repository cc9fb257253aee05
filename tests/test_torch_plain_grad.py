"""The gradients of the three kernels that have no backward kernel yet
(ROADMAP C14): ``GroupedMatmulFn``, ``SSDScanFn`` and ``WKV6Fn`` run the
forward they are given (on the card, the kernel's launch) and recompute
their plain version for the backward.

On the CPU there is no kernel, so each Function is driven with a forward
the test supplies: the reference's Pallas kernel in interpret mode,
carried across as a torch tensor. Its gradient must equal autograd
through the port's plain version (the same computation, to float32
rounding), and the reference's ``jax.vjp`` of its ``ref`` function at the
kernel tests' float32 tolerance. The integer offsets and counts of the
grouped matmul get no gradient. On the card the same Functions are held
against the all-plain gradient of ``LM.loss`` (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import moe_gmm as pallas_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref
from repro.kernels.ssd_scan.ops import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.moe_gmm.ops import (GroupedMatmulFn,
                                             grouped_matmul_plain)
from repro_torch.kernels.plain_grad import needs_grad, plain_grads
from repro_torch.kernels.rwkv6.ops import WKV6Fn, wkv6_plain
from repro_torch.kernels.ssd_scan.ops import SSDScanFn, ssd_scan_plain

torch.set_num_threads(1)

# the plain backward against autograd through the plain version: the same
# operations, so only float32 rounding of the recomputation's order
SAME = dict(rtol=1e-5, atol=1e-6)
# against jax.vjp of the reference's ref: the kernel tests' float32 rule
REF_RTOL = 5e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _stand_in(fn, calls):
    """A forward for a Function: the reference's Pallas kernel in interpret
    mode on the same values, returned as a torch tensor."""
    def kernel(*args):
        calls.append(len(args))
        return _t(fn(*args))
    return kernel


def _close_to_ref(got: torch.Tensor, want, label: str) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= REF_RTOL * scale, (label, err, scale)


def _autograd_plain(plain, inputs, dy, *args, **kw):
    leaves = [t.detach().requires_grad_(t.dtype.is_floating_point)
              for t in inputs]
    y = plain(*leaves, *args, **kw)
    return torch.autograd.grad(
        y, [t for t in leaves if t.requires_grad], dy)


@pytest.mark.parametrize("E,C,D,F", [(4, 24, 32, 40), (2, 17, 48, 16)])
def test_grouped_matmul_fn_grads(E, C, D, F):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.normal(size=(E, C, F)).astype(np.float32)
    offsets = torch.arange(E, dtype=torch.int32) * C
    counts = torch.full((E,), C, dtype=torch.int32)
    calls = []

    def kernel(xr, wt, off, cnt):
        calls.append(1)
        out = pallas_moe_gmm(jnp.asarray(xr.numpy().reshape(E, C, D)),
                             jnp.asarray(wt.numpy()), interpret=True)
        return _t(out).reshape(E * C, F)

    xt = _t(x).reshape(E * C, D).requires_grad_()
    wt = _t(w).requires_grad_()
    y = GroupedMatmulFn.apply(xt, wt, offsets, counts, kernel)
    assert calls == [1] and y.grad_fn is not None
    _close_to_ref(y.detach().reshape(E, C, F), moe_gmm_ref(x, w), "forward")
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(dy).reshape(E * C, F))
    want = _autograd_plain(grouped_matmul_plain, (xt, wt),
                           _t(dy).reshape(E * C, F), offsets, counts)
    torch.testing.assert_close(dx, want[0], **SAME)
    torch.testing.assert_close(dw, want[1], **SAME)
    _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    rx, rw = vjp(jnp.asarray(dy))
    _close_to_ref(dx.reshape(E, C, D), rx, "dx")
    _close_to_ref(dw, rw, "dw")


def test_grouped_matmul_fn_ragged_groups_and_integer_inputs():
    """Ragged groups with an empty one and rows in no group: the rows in no
    group get a zero gradient, and the routing (offsets, counts) none."""
    rng = np.random.default_rng(1)
    R, D, F = 30, 16, 12
    offsets = torch.tensor([0, 7, 7, 20], dtype=torch.int32)
    counts = torch.tensor([7, 0, 9, 6], dtype=torch.int32)
    x = _t(rng.normal(size=(R, D))).requires_grad_()
    w = _t(rng.normal(size=(4, D, F))).requires_grad_()
    dy = _t(rng.normal(size=(R, F)))
    plain = lambda *a: grouped_matmul_plain(*a)          # noqa: E731
    y = GroupedMatmulFn.apply(x, w, offsets, counts, plain)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    want = _autograd_plain(grouped_matmul_plain, (x, w), dy, offsets, counts)
    torch.testing.assert_close(dx, want[0], **SAME)
    torch.testing.assert_close(dw, want[1], **SAME)
    assert float(dx[16:20].abs().max()) == 0.0          # rows in no group
    grads = GroupedMatmulFn.backward(
        type("Ctx", (), {"saved_tensors": (x, w, offsets, counts),
                         "needs_input_grad": (True, True, False, False,
                                              False)})(), dy)
    assert grads[2] is None and grads[3] is None and grads[4] is None


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, P)), np.abs(rng.normal(size=(B, S, H))),
            -np.abs(rng.normal(size=(H,))), rng.normal(size=(B, S, N)),
            rng.normal(size=(B, S, N)), rng.normal(size=(B, S, H, P))]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 100, 3, 32, 16, 32),
                                             (1, 33, 2, 16, 8, 16)])
def test_ssd_scan_fn_grads(B, S, H, P, N, chunk):
    *arrs, dy = [np.asarray(a, np.float32)
                 for a in _ssd_inputs(B, S, H, P, N)]
    calls = []
    kernel = _stand_in(
        lambda *a: pallas_ssd_scan(*map(jnp.asarray, (t.detach().numpy()
                                                      for t in a[:5])),
                                   chunk=a[5], interpret=True), calls)
    ins = [_t(a).requires_grad_() for a in arrs]
    y = SSDScanFn.apply(*ins, chunk, kernel)
    assert calls == [6] and y.grad_fn is not None
    _close_to_ref(y.detach(), ssd_scan_ref(*arrs, chunk=chunk), "forward")
    got = torch.autograd.grad(y, ins, _t(dy))
    want = _autograd_plain(ssd_scan_plain, ins, _t(dy), chunk=chunk)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **SAME)
    _, vjp = jax.vjp(lambda *a: ssd_scan_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, g, r in zip(("xh", "dt", "A", "Bm", "Cm"), got,
                          vjp(jnp.asarray(dy))):
        _close_to_ref(g, r, name)


@pytest.mark.parametrize("B,S,H,P,chunk", [(2, 100, 3, 32, 25),
                                           (1, 31, 2, 16, 8)])
def test_wkv6_fn_grads(B, S, H, P, chunk):
    rng = np.random.default_rng(2)
    r, k, v = (rng.normal(size=(B, S, H, P)).astype(np.float32)
               for _ in range(3))
    lw = (-np.exp(rng.normal(size=(B, S, H, P)) * 0.5 - 1.0)) \
        .astype(np.float32)
    u = rng.normal(size=(H, P)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    arrs = [r, k, v, lw, u]
    calls = []
    kernel = _stand_in(
        lambda *a: pallas_wkv6(*map(jnp.asarray, (t.detach().numpy()
                                                  for t in a[:5])),
                               chunk=a[5], interpret=True), calls)
    ins = [_t(a).requires_grad_() for a in arrs]
    y = WKV6Fn.apply(*ins, chunk, kernel)
    assert calls == [6] and y.grad_fn is not None
    _close_to_ref(y.detach(), wkv6_ref(*arrs, chunk=chunk), "forward")
    got = torch.autograd.grad(y, ins, _t(dy))
    want = _autograd_plain(wkv6_plain, ins, _t(dy), chunk=chunk)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **SAME)
    _, vjp = jax.vjp(lambda *a: wkv6_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, g, rr in zip(("r", "k", "v", "lw", "u"), got,
                           vjp(jnp.asarray(dy))):
        _close_to_ref(g, rr, name)


def test_only_inputs_that_need_a_gradient_get_one():
    """A frozen input gets ``None`` and is not differentiated; with none
    needing one the plain version is not recomputed at all."""
    rng = np.random.default_rng(3)
    ins = [_t(a) for a in _ssd_inputs(1, 20, 2, 8, 4)[:5]]
    ins[0].requires_grad_()
    y = SSDScanFn.apply(*ins, 8, lambda *a: ssd_scan_plain(*a[:5],
                                                           chunk=a[5]))
    dy = _t(rng.normal(size=y.shape))
    (dx,) = torch.autograd.grad(y, ins[0], dy)
    want = _autograd_plain(lambda x: ssd_scan_plain(x, *ins[1:], chunk=8),
                           ins[:1], dy)
    torch.testing.assert_close(dx, want[0], **SAME)
    recomputed = []
    assert plain_grads(lambda *a: recomputed.append(1), ins,
                       [False] * 5, dy) == [None] * 5
    assert recomputed == []
    with torch.no_grad():
        assert not needs_grad(ins[0])
    assert needs_grad(ins[1], ins[0]) and not needs_grad(ins[1])
