"""The port's grouped expert matmul (``repro_torch/kernels/moe_gmm``) on the
CPU, where its wrappers compute the plain versions.

``moe_gmm`` (the reference's dense-grouped interface) against the
reference's Pallas kernel in interpret mode and its ``moe_gmm_ref`` on
``tests/test_kernels.py::TestMoEGMM``'s sweep, with that test's tolerances
(float32 rtol 2e-4 / atol 2e-5; bfloat16 3e-2 / 3e-2). The ragged
``grouped_matmul`` against per-expert products in float64 numpy, on empty
groups, a group that takes every row, unaligned widths and rows outside
every group (f32 tolerance: the same as above). The wrappers' refusals.
The CUDA kernel itself is held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import moe_gmm as ref_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.core import lockcheck
from repro_torch.core.bridge import params_from_reference
from repro_torch.kernels.moe_gmm.ops import (grouped_matmul,
                                             grouped_matmul_plain, moe_gmm,
                                             moe_gmm_plain)

torch.set_num_threads(1)

SWEEP = [(4, 100, 96, 130), (2, 64, 64, 64), (8, 16, 48, 32)]


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


def _port(a):
    """A JAX array as a CPU tensor of the same dtype (bf16 included)."""
    return params_from_reference({"a": np.asarray(a)}, device="cpu")["a"]


@pytest.mark.parametrize("E,C,D,F", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_reference(E, C, D, F, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(E, C, D)), dtype)
    w = jnp.asarray(rng.normal(size=(E, D, F)), dtype)
    pallas = np.asarray(ref_moe_gmm(x, w, block_c=64, block_f=64, block_d=32,
                                    interpret=True), np.float32)
    ref = np.asarray(moe_gmm_ref(x, w), np.float32)
    px, pw = _port(x), _port(w)
    for got in (moe_gmm(px, pw), moe_gmm_plain(px, pw)):
        assert got.dtype == px.dtype and tuple(got.shape) == (E, C, F)
        got = got.float().numpy()
        np.testing.assert_allclose(got, ref, **_tol(dtype))
        np.testing.assert_allclose(got, pallas, **_tol(dtype))


# (rows R, D, F, [(offset, count) per expert]); rows in no group keep the
# sentinel written into ``out`` beforehand
RAGGED = [
    ("empty-groups", 40, 64, 48, [(0, 0), (0, 17), (17, 0), (17, 23)]),
    ("one-group-takes-all", 50, 32, 70, [(0, 0), (0, 50), (50, 0)]),
    ("unaligned", 37, 33, 130, [(0, 5), (5, 1), (6, 31)]),
    ("rows-outside-groups", 64, 48, 40, [(3, 10), (20, 0), (20, 7),
                                         (40, 20)]),
    ("decode-like", 48, 128, 88, [(0, 2)] + [(2 + i, 1) for i in range(30)]
     + [(32, 16)] + [(48, 0)] * 32),
]


@pytest.mark.parametrize("case", RAGGED, ids=[c[0] for c in RAGGED])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_plain_on_ragged_groups(case, dtype):
    _, R, D, F, groups = case
    E = len(groups)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(R, D))).to(dtype)
    w = torch.from_numpy(rng.normal(size=(E, D, F))).to(dtype)
    offsets = torch.tensor([o for o, _ in groups], dtype=torch.int32)
    counts = torch.tensor([c for _, c in groups], dtype=torch.int32)
    want = np.full((R, F), 7.0)
    xf, wf = x.double().numpy(), w.double().numpy()
    for e, (o, c) in enumerate(groups):
        want[o:o + c] = xf[o:o + c] @ wf[e]
    tol = _tol("bfloat16" if dtype == torch.bfloat16 else "float32")
    for fn in (grouped_matmul, grouped_matmul_plain):
        out = torch.full((R, F), 7.0, dtype=dtype)
        got = fn(x, w, offsets, counts, out=out)
        assert got is out
        np.testing.assert_allclose(got.double().numpy(), want, **tol)
    fresh = grouped_matmul(x, w, offsets, counts)     # rows in no group: 0
    outside = np.ones(R, bool)
    for o, c in groups:
        outside[o:o + c] = False
    assert (fresh[torch.from_numpy(outside)] == 0).all()


def test_grouped_matmul_reads_a_layer_view_of_stacked_weights():
    """w[i] of a stacked [L, E, D, F] leaf is a view; no copy is needed."""
    rng = np.random.default_rng(2)
    stacked = torch.from_numpy(rng.normal(size=(3, 4, 16, 24))).float()
    x = torch.from_numpy(rng.normal(size=(10, 16))).float()
    offsets = torch.tensor([0, 2, 2, 7], dtype=torch.int32)
    counts = torch.tensor([2, 0, 5, 3], dtype=torch.int32)
    got = grouped_matmul(x, stacked[1], offsets, counts)
    want = grouped_matmul_plain(x, stacked[1].contiguous(), offsets, counts)
    assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernel_cannot_take():
    x = torch.zeros(8, 16)
    w = torch.zeros(2, 16, 4)
    off = torch.tensor([0, 4], dtype=torch.int32)
    cnt = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises(TypeError):
        grouped_matmul(x.int(), w.int(), off, cnt)
    with pytest.raises(ValueError, match="w is"):
        grouped_matmul(x, w.double(), off, cnt)
    with pytest.raises(ValueError, match=r"\[R, D\]"):
        grouped_matmul(x[None], w, off, cnt)
    with pytest.raises(ValueError, match=r"\[R, D\]"):
        grouped_matmul(x, torch.zeros(2, 15, 4), off, cnt)
    with pytest.raises(ValueError, match="offsets"):
        grouped_matmul(x, w, off.long(), cnt)
    with pytest.raises(ValueError, match="counts"):
        grouped_matmul(x, w, off, cnt[:1])
    with pytest.raises(ValueError, match="contiguous last"):
        grouped_matmul(torch.zeros(16, 8).t(), w, off, cnt)
    with pytest.raises(ValueError, match="contiguous last"):
        grouped_matmul(x, torch.zeros(2, 4, 16).transpose(1, 2), off, cnt)
    with pytest.raises(ValueError, match="out must be"):
        grouped_matmul(x, w, off, cnt, out=torch.zeros(8, 5))
    # a meta tensor holds shapes only: no launch, an empty output and the
    # kernel's counted work for the dry run (kernels/shape_only.py)
    from repro_torch.kernels.moe_gmm.ops import gmm_cost
    from repro_torch.kernels.shape_only import recording
    seen = []
    with recording(lambda *a: seen.append(a)):
        y = grouped_matmul(x.to("meta"), w.to("meta"), off.to("meta"),
                           cnt.to("meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (8, 4)
    assert seen == [("moe_gmm", *gmm_cost(8, 16, 4, 2, 4))]
    with pytest.raises(ValueError, match=r"\[E, C, D\]"):
        moe_gmm(x, w)
    with pytest.raises(ValueError, match="without a copy"):
        moe_gmm(torch.zeros(2, 5, 16)[:, :4], w)
    before = moe_gmm.launches
    moe_gmm(torch.zeros(2, 4, 16), w)            # the CPU launches nothing
    assert moe_gmm.launches == before
