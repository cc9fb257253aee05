"""Static placement of op results (ROADMAP C2), on the CPU.

With ``out`` (an arena extent) every op of the registry writes its result
there and allocates no full-size temporary: every tensor an op creates
beside ``out`` is at most ``ROW_SCRATCH_BYTES`` (rmsnorm_bwd's float64 row
chunks; the rest are a reduction's ``[..., 1]``, LoRA's ``[T, rank]`` or
the causal mask's 128-square tile). Checked by intercepting every aten
call the op makes (``TorchDispatchMode``) at shapes whose full tensors are
4-8x that limit. The card-side bound (peak allocated HBM within the arena,
the returned outputs and the stated cuBLAS workspace) is held by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import lockcheck
from repro_torch.core.ops import MASK_BLOCK, ROW_SCRATCH_BYTES, get_op

torch.set_num_threads(1)

H, N, M, D = 4, 512, 512, 64            # 4 MiB of float32 per [H, N, M]
T, W = 1024, 1024                       # 4 MiB of float32 per [T, W]

# op -> (operand shapes, params); every result is >= 4 x ROW_SCRATCH_BYTES.
# rmsnorm is not here: on the CPU its wrapper runs the kernel's plain
# version, and on the card the kernel writes into out with no scratch
CASES = {
    "copy": ([(T, W)], {}),
    "add": ([(T, W), (T, W)], {}),
    "sum": ([(T, W)] * 3, {}),
    "mul": ([(T, W), (T, W)], {}),
    "scale": ([(T, W)], {"alpha": 0.5}),
    "matmul": ([(T, D), (D, W)], {}),
    "matmul_t": ([(T, D), (W, D)], {}),
    "matmul_tn": ([(D, T), (D, W)], {}),
    "relu": ([(T, W)], {}),
    "gelu": ([(T, W)], {}),
    "silu": ([(T, W)], {}),
    "tanh": ([(T, W)], {}),
    "transpose": ([(T, W)], {}),
    "slice_rows": ([(2 * T, W)], {"start": 3, "stop": T + 3}),
    "concat": ([(T // 2, W), (T // 2, W)], {"axis": 0}),
    "rmsnorm_bwd": ([(T, W), (W,), (T, W)], {"eps": 1e-6}),
    "softmax": ([(H, N, M)], {}),
    "softmax_bwd": ([(H, N, M), (H, N, M)], {}),
    "gelu_bwd": ([(T, W), (T, W)], {}),
    "scores": ([(H, N, D), (H, M, D)],
               {"scale": 0.125, "causal": True, "q_offset": 0}),
    "scores_offset": ([(H, N // 2, D), (H, 2 * M, D)],
                      {"scale": 0.125, "causal": True, "q_offset": 700}),
    "attn_out": ([(H, N, M), (H, M, W)], {}),
    "lora_delta": ([(T, W), (16, W), (W, 16)], {"alpha": 16.0,
                                               "rank": 16}),
    "split_heads": ([(T, W)], {"n_heads": 8}),
    "merge_heads": ([(8, T, W // 8)], {}),
    "slice_rows_3d": ([(8, 2 * T, W // 8)], {"start": 5, "stop": T + 5}),
}


@pytest.fixture(autouse=True)
def _port_lock_order_sanitizer():
    lockcheck.reset()
    lockcheck.enable()
    yield
    lockcheck.disable()
    lockcheck.assert_acyclic()


class FreshAllocations(TorchDispatchMode):
    """Records the byte size of every storage an aten call returns that is
    none of the storages it was given."""

    def __init__(self, known):
        super().__init__()
        self.known = set(known)
        self.sizes: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st.data_ptr() not in self.known:
                    self.known.add(st.data_ptr())
                    self.sizes.append((str(func), st.nbytes()))
        return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_with_out_allocates_only_row_scratch(case):
    name = "scores" if case == "scores_offset" else case
    shapes, params = CASES[case]
    gen = torch.Generator().manual_seed(0)
    vals = [torch.randn(s, generator=gen) for s in shapes]
    fn = get_op(name)
    fresh = fn(*vals, **params)
    assert fresh.numel() * 4 >= 4 * ROW_SCRATCH_BYTES, case
    buf = torch.zeros(fresh.numel() * 4 + 64, dtype=torch.uint8)
    dest = buf[64:].view(torch.float32).view(fresh.shape)
    known = [v.untyped_storage().data_ptr() for v in vals] + \
        [buf.untyped_storage().data_ptr()]
    with FreshAllocations(known) as mode:
        got = fn(*vals, out=dest, **params)
    assert got.data_ptr() == dest.data_ptr()
    assert torch.equal(dest, fresh)
    big = [(f, n) for f, n in mode.sizes if n > ROW_SCRATCH_BYTES]
    assert not big, f"{case} allocated beside out: {big}"


@pytest.mark.parametrize("n,m,q_offset", [(1, 1, 0), (5, 9, 4), (130, 300, 0),
                                          (257, 640, 383), (200, 129, -1),
                                          (384, 1024, 640), (3, 700, 600)])
def test_causal_fill_matches_the_reference_mask(n, m, q_offset):
    """The blocked causal fill masks exactly j > i + q_offset, for blocks
    that are full, ragged, clipped left (negative band start) and right."""
    q = torch.randn(2, n, 8, dtype=torch.float64)
    k = torch.randn(2, m, 8, dtype=torch.float64)
    s = get_op("scores")(q, k, scale=0.5, causal=True, q_offset=q_offset)
    raw = torch.matmul(q, k.transpose(-1, -2)) * 0.5
    masked = torch.arange(m)[None, :] > (torch.arange(n) + q_offset)[:, None]
    want = raw.masked_fill(masked, -1e30)
    assert torch.equal(s, want)
    assert MASK_BLOCK * MASK_BLOCK <= ROW_SCRATCH_BYTES
    assert math.isfinite(s[0, 0, 0].item()) or q_offset < 0
