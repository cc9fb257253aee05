"""The ``autograd.Function``s of the three kernels that have a backward
kernel beside their forward (ROADMAP B5): ``GroupedMatmulFn``,
``SSDScanFn`` and ``WKV6Fn`` run the forward and the backward they are
given (on the card, the two kernels' launches).

On the CPU there is no kernel, so each Function is driven with stand-ins
the test supplies: the reference's Pallas kernel in interpret mode for the
forward, carried across as a torch tensor, and the backward kernel's
passes emulated in torch (``test_torch_bwd_kernels.py``) for the backward.
The gradients must be the emulation's, called once with what the Function
saved, and within the kernel tests' float32 rule of the reference's
``jax.vjp`` of its ``ref`` function. The integer offsets and counts of the
grouped matmul get no gradient, nor does an input that needs none. On
shape-only tensors (meta, as the dry run makes them) the Functions record
the backward kernels and never reach a plain version or ``plain_grads``;
``tests/test_torch_cuda.py`` holds the same on CUDA tensors, and the same
Functions against the all-plain gradient of ``LM.loss``.
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
from repro_torch.kernels import plain_grad
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ops import (GroupedMatmulFn,
                                             grouped_matmul_plain)
from repro_torch.kernels.plain_grad import needs_grad, plain_grads
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ops import WKV6Fn
from repro_torch.kernels.shape_only import recording
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import SSDScanFn, ssd_scan_plain
from test_torch_bwd_kernels import (gmm_bwd_emulated, ssd_bwd_emulated,
                                    wkv6_bwd_emulated)

torch.set_num_threads(1)

# the Function's gradient against the stand-in backward called directly:
# the same computation, so only float32 rounding of the recomputation
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


def _counted(fn, calls):
    """A backward stand-in: ``fn`` (an emulation), its calls recorded."""
    def backward(*args, **kw):
        calls.append(len(args))
        return fn(*args, **kw)
    return backward


def _close_to_ref(got: torch.Tensor, want, label: str) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= REF_RTOL * scale, (label, err, scale)


def _gmm_backward(x, w, offsets, counts, dy, *, need_dx, need_dw, rows):
    """GroupedMatmulFn's backward stand-in: the emulated kernel, with only
    the gradients asked."""
    dx, dw = gmm_bwd_emulated(x, w, offsets, counts, dy)
    return dx if need_dx else None, dw if need_dw else None


def _scan_backward(emulated):
    def backward(*args):
        *ins, dy, chunk = args
        out = emulated(*ins, dy, chunk=chunk)
        return out[0] if emulated is wkv6_bwd_emulated else out
    return backward


@pytest.mark.parametrize("E,C,D,F", [(4, 24, 32, 40), (2, 17, 48, 16)])
def test_grouped_matmul_fn_grads(E, C, D, F):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    dy = rng.normal(size=(E, C, F)).astype(np.float32)
    offsets = torch.arange(E, dtype=torch.int32) * C
    counts = torch.full((E,), C, dtype=torch.int32)
    calls, bwd_calls = [], []

    def kernel(xr, wt, off, cnt):
        calls.append(1)
        out = pallas_moe_gmm(jnp.asarray(xr.numpy().reshape(E, C, D)),
                             jnp.asarray(wt.numpy()), interpret=True)
        return _t(out).reshape(E * C, F)

    xt = _t(x).reshape(E * C, D).requires_grad_()
    wt = _t(w).requires_grad_()
    y = GroupedMatmulFn.apply(xt, wt, offsets, counts, kernel,
                              _counted(_gmm_backward, bwd_calls))
    assert calls == [1] and y.grad_fn is not None
    _close_to_ref(y.detach().reshape(E, C, F), moe_gmm_ref(x, w), "forward")
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(dy).reshape(E * C, F))
    assert bwd_calls == [5]
    want = gmm_bwd_emulated(xt.detach(), wt.detach(), offsets, counts,
                            _t(dy).reshape(E * C, F))
    torch.testing.assert_close(dx, want[0], **SAME)
    torch.testing.assert_close(dw, want[1], **SAME)
    _, vjp = jax.vjp(moe_gmm_ref, jnp.asarray(x), jnp.asarray(w))
    rx, rw = vjp(jnp.asarray(dy))
    _close_to_ref(dx.reshape(E, C, D), rx, "dx")
    _close_to_ref(dw, rw, "dw")


def test_grouped_matmul_fn_ragged_groups_and_integer_inputs():
    """Ragged groups with an empty one and rows in no group: the rows in no
    group get a zero gradient, the empty group's weights a zero one, and
    the routing (offsets, counts) none; with x frozen only dw is asked."""
    rng = np.random.default_rng(1)
    R, D, F = 30, 16, 12
    offsets = torch.tensor([0, 7, 7, 20], dtype=torch.int32)
    counts = torch.tensor([7, 0, 9, 6], dtype=torch.int32)
    x = _t(rng.normal(size=(R, D))).requires_grad_()
    w = _t(rng.normal(size=(4, D, F))).requires_grad_()
    dy = _t(rng.normal(size=(R, F)))
    plain = lambda *a: grouped_matmul_plain(*a)          # noqa: E731
    y = GroupedMatmulFn.apply(x, w, offsets, counts, plain, _gmm_backward)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    want = plain_grads(grouped_matmul_plain, (x, w), (True, True), dy,
                       offsets, counts)
    torch.testing.assert_close(dx, want[0], **SAME)
    torch.testing.assert_close(dw, want[1], **SAME)
    assert float(dx[16:20].abs().max()) == 0.0          # rows in no group
    assert float(dw[1].abs().max()) == 0.0              # the empty group
    asked = []

    def backward(*args, need_dx, need_dw, rows):
        asked.append((need_dx, need_dw))
        return _gmm_backward(*args, need_dx=need_dx, need_dw=need_dw,
                             rows=rows)
    y = GroupedMatmulFn.apply(x.detach(), w, offsets, counts, plain,
                              backward)
    (dw_only,) = torch.autograd.grad(y, (w,), dy)
    assert asked == [(False, True)]
    torch.testing.assert_close(dw_only, dw, **SAME)
    ctx = type("Ctx", (), {"saved_tensors": (x, w, offsets, counts),
                           "needs_input_grad": (True, True, False, False,
                                                False, False),
                           "rows": None, "bwd": staticmethod(_gmm_backward)})
    grads = GroupedMatmulFn.backward(ctx(), dy)
    assert len(grads) == 6 and all(g is None for g in grads[2:])


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
    calls, bwd_calls = [], []
    kernel = _stand_in(
        lambda *a: pallas_ssd_scan(*map(jnp.asarray, (t.detach().numpy()
                                                      for t in a[:5])),
                                   chunk=a[5], interpret=True), calls)
    ins = [_t(a).requires_grad_() for a in arrs]
    y = SSDScanFn.apply(*ins, chunk, kernel,
                        _counted(_scan_backward(ssd_bwd_emulated), bwd_calls))
    assert calls == [6] and y.grad_fn is not None
    _close_to_ref(y.detach(), ssd_scan_ref(*arrs, chunk=chunk), "forward")
    got = torch.autograd.grad(y, ins, _t(dy))
    assert bwd_calls == [7]
    want = ssd_bwd_emulated(*(t.detach() for t in ins), _t(dy), chunk=chunk)
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
    calls, bwd_calls = [], []
    kernel = _stand_in(
        lambda *a: pallas_wkv6(*map(jnp.asarray, (t.detach().numpy()
                                                  for t in a[:5])),
                               chunk=a[5], interpret=True), calls)
    ins = [_t(a).requires_grad_() for a in arrs]
    y = WKV6Fn.apply(*ins, chunk, kernel,
                     _counted(_scan_backward(wkv6_bwd_emulated), bwd_calls))
    assert calls == [6] and y.grad_fn is not None
    _close_to_ref(y.detach(), wkv6_ref(*arrs, chunk=chunk), "forward")
    got = torch.autograd.grad(y, ins, _t(dy))
    assert bwd_calls == [7]
    want, _ = wkv6_bwd_emulated(*(t.detach() for t in ins), _t(dy),
                                chunk=chunk)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **SAME)
    _, vjp = jax.vjp(lambda *a: wkv6_ref(*a, chunk=chunk),
                     *map(jnp.asarray, arrs))
    for name, g, rr in zip(("r", "k", "v", "lw", "u"), got,
                           vjp(jnp.asarray(dy))):
        _close_to_ref(g, rr, name)


def test_only_inputs_that_need_a_gradient_get_one():
    """A frozen input gets ``None`` from the Function; ``plain_grads`` (the
    plain backward the CPU wrappers and the card's comparisons use) does
    not recompute the plain version when no input needs a gradient."""
    rng = np.random.default_rng(3)
    ins = [_t(a) for a in _ssd_inputs(1, 20, 2, 8, 4)[:5]]
    ins[0].requires_grad_()
    y = SSDScanFn.apply(*ins, 8, lambda *a: ssd_scan_plain(*a[:5],
                                                           chunk=a[5]),
                        _scan_backward(ssd_bwd_emulated))
    dy = _t(rng.normal(size=y.shape))
    (dx,) = torch.autograd.grad(y, ins[0], dy)
    want = plain_grads(lambda x: ssd_scan_plain(x, *ins[1:], chunk=8),
                       ins[:1], (True,), dy)
    torch.testing.assert_close(dx, want[0], rtol=REF_RTOL, atol=1e-5)
    grads = SSDScanFn.backward(
        type("Ctx", (), {"saved_tensors": tuple(ins), "chunk": 8,
                         "needs_input_grad": (True,) + (False,) * 7,
                         "bwd": staticmethod(_scan_backward(
                             ssd_bwd_emulated))})(), dy)
    assert grads[0] is not None and all(g is None for g in grads[1:])
    recomputed = []
    assert plain_grads(lambda *a: recomputed.append(1), ins,
                       [False] * 5, dy) == [None] * 5
    assert recomputed == []
    with torch.no_grad():
        assert not needs_grad(ins[0])
    assert needs_grad(ins[1], ins[0]) and not needs_grad(ins[1])


def _refuse(*args, **kw):
    raise AssertionError("a plain version ran on a shape-only tensor")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_never_run_plain_on_shape_only_tensors(monkeypatch, dtype):
    """Under grad on meta tensors (the dry run's), forward and backward of
    the three wrappers record the kernels (``moe_gmm`` and ``moe_gmm_bwd``,
    ``ssd_scan`` and ``ssd_scan_bwd``, ``wkv6`` and ``wkv6_bwd``) and give
    every input a gradient of its shape and dtype; ``plain_grads`` and
    every ``*_plain`` function raise if reached."""
    for mod, names in ((plain_grad, ("plain_grads",)),
                       (gmm_ops, ("plain_grads", "grouped_matmul_plain",
                                  "grouped_matmul_bwd_plain",
                                  "moe_gmm_plain")),
                       (ssd_ops, ("plain_grads", "ssd_scan_plain",
                                  "ssd_scan_bwd_plain")),
                       (wkv_ops, ("plain_grads", "wkv6_plain",
                                  "wkv6_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    seen = []

    def leaf(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta").requires_grad_()
    cases = [
        (gmm_ops.grouped_matmul, (leaf(40, 16), leaf(4, 16, 24)),
         (torch.zeros(4, dtype=torch.int32, device="meta"),
          torch.full((4,), 10, dtype=torch.int32, device="meta"))),
        (ssd_ops.ssd_scan, (leaf(2, 50, 3, 8), leaf(2, 50, 3),
                            leaf(3, dt=torch.float32), leaf(2, 50, 4),
                            leaf(2, 50, 4)), ()),
        (wkv_ops.wkv6, (leaf(2, 50, 3, 8), leaf(2, 50, 3, 8),
                        leaf(2, 50, 3, 8), leaf(2, 50, 3, 8),
                        leaf(3, 8, dt=torch.float32)), ())]
    with recording(lambda name, ops, nbytes: seen.append(name)):
        for fn, grads_of, rest in cases:
            y = fn(*grads_of, *rest)
            got = torch.autograd.grad(y, grads_of, torch.ones_like(y))
            assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] \
                == [(tuple(t.shape), t.dtype, "meta") for t in grads_of]
    assert seen == ["moe_gmm", "moe_gmm_bwd", "ssd_scan", "ssd_scan_bwd",
                    "wkv6", "wkv6_bwd"]
