"""The frozen cost copies against the program's own functions, at the
main-path shape and a few others, and the bound at the kernel table's
shape."""
from __future__ import annotations

import pytest

from turnip_bench.costs import peaks, wkv6

WKV = [(2, 8192, 64, 64, 32), (1, 100, 4, 16, 32), (3, 33, 2, 64, 16)]


@pytest.mark.parametrize("shape", WKV)
def test_wkv6_bwd_cost_equals_the_programs(shape):
    from repro_torch.kernels.rwkv6 import ops
    assert wkv6.wkv6_bwd_cost(*shape, 4) == ops.wkv6_bwd_cost(*shape, 4)
    assert sum(wkv6.wkv6_bwd_ops_split(*shape)) == ops.wkv6_bwd_ops(*shape)


def test_wkv6_bwd_bound_at_the_main_path_shape():
    # at 2 x 8192, 64 heads of 64, chunk 32: 53.62 GFLOP of products and
    # 7.65 of the rest (0.4392 ms at 165 and 67 TFLOP/s) against 2.42 GB
    # read and written (0.7212 ms at 3.35 TB/s): bound by the bytes
    products, rest = wkv6.wkv6_bwd_ops_split(2, 8192, 64, 64, 32)
    assert (products, rest) == (53619982336, 7650410496)
    t_ops = products / peaks.F32_TC_FLOPS + rest / peaks.F32_FLOPS
    assert t_ops * 1e3 == pytest.approx(0.4392, abs=5e-5)
    assert wkv6.wkv6_bwd_bound_s(2, 8192, 64, 64, 32, 4) * 1e3 == \
        pytest.approx(0.7212, abs=5e-5)
