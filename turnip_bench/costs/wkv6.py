"""RWKV-6's WKV backward's operations and bytes: a frozen copy of
``repro_torch/kernels/rwkv6/ops.py`` (``wkv6_bwd_ops``,
``wkv6_bwd_cost``), its operations split into products and the rest, and
its least time priced as every scan's is: the products at the
float32-accurate tensor-core rate, the rest at the float32 rate."""
from __future__ import annotations

from . import peaks


def wkv6_bwd_ops_split(B, S, H, P, chunk) -> tuple[int, int]:
    """(products, the rest); two operations a multiply-add. Per chunk of n
    rows, per (b, h): the strict lower triangle's pair terms three times
    (A, dr, dk: n(n-1)/2 x P, each a multiply-add of the factored r and k,
    a product with the decay and an exponential: 2 in the products, 2 in
    the rest), dA and A^T dy (n(n+1)/2 x P multiply-adds each), the bonus
    terms (9 n P, rest), five n x P x P products, the two carries (2 x P x
    P, elementwise: rest) and dlw's sums (4 n P, rest)."""
    products = rest = 0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        tri, tri1 = n * (n - 1) // 2, n * (n + 1) // 2
        products += 3 * 2 * tri * P + 2 * 2 * tri1 * P + 2 * 5 * n * P * P
        rest += 3 * 2 * tri * P + 9 * n * P + 2 * 2 * P * P + 4 * n * P
    return products * B * H, rest * B * H


def wkv6_bwd_cost(B, S, H, P, chunk, itemsize) -> tuple[int, int]:
    """(operations, bytes): r, k, v, lw and dy read once, dr, dk, dv and
    dlw written once."""
    return (sum(wkv6_bwd_ops_split(B, S, H, P, chunk)),
            9 * B * S * H * P * itemsize)


def wkv6_bwd_bound_s(B, S, H, P, chunk, itemsize) -> float:
    """The VJP's least time: its bytes at the memory rate, or its products
    at the float32-accurate tensor-core rate plus the rest at the float32
    rate, whichever is longer."""
    products, rest = wkv6_bwd_ops_split(B, S, H, P, chunk)
    nbytes = wkv6_bwd_cost(B, S, H, P, chunk, itemsize)[1]
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               products / peaks.F32_TC_FLOPS + rest / peaks.F32_FLOPS)
