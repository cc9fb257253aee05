"""RWKV-6's WKV forward's operations and bytes: a frozen copy of
``repro_torch/kernels/rwkv6/ops.py`` (``wkv6_ops``, ``wkv6_cost``), its
operations split into products and the rest, and its least time priced as
the backward's is (``costs/wkv6.py``): the products at the
float32-accurate tensor-core rate, the rest at the float32 rate, against
the bytes."""
from __future__ import annotations

from . import peaks


def wkv6_ops_split(B, S, H, P, chunk) -> tuple[int, int]:
    """(products, the rest); two operations a multiply-add. Per chunk of n
    rows, per (b, h): the strict lower triangle's A terms (n(n-1)/2 x P,
    each a multiply-add of r and k with the decay, 2 in the products, and
    its exponential and sum, 2 in the rest), A v (n(n-1)/2 x P
    multiply-adds, products), the bonus (5 n P, rest), the incoming-state
    term and the state update (n x P x P multiply-adds each, products) and
    their decay factors (2 n P each, rest)."""
    products = rest = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri = n * (n - 1) // 2
        products += 2 * tri * P + 2 * tri * P + 2 * 2 * n * P * P
        rest += 2 * tri * P + 5 * n * P + 2 * 2 * n * P
    return products * B * H, rest * B * H


def wkv6_cost(B, S, H, P, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): r, k, v, lw read once and y written once."""
    return (sum(wkv6_ops_split(B, S, H, P, chunk)),
            5 * B * S * H * P * itemsize)


def wkv6_bound_s(B, S, H, P, chunk, itemsize) -> tuple[float, str]:
    """The forward's least time, and which of ``"bytes"`` and
    ``"operations"`` binds it: its bytes at the memory rate, or its
    products at the float32-accurate tensor-core rate plus the rest at the
    float32 rate, whichever is longer."""
    products, rest = wkv6_ops_split(B, S, H, P, chunk)
    nbytes = wkv6_cost(B, S, H, P, chunk, itemsize)[1]
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = products / peaks.F32_TC_FLOPS + rest / peaks.F32_FLOPS
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
