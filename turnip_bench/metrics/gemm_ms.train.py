"""Device milliseconds a training step in cuBLAS and CUTLASS GEMM kernels
(forward, recompute and backward products, the adapters' merges)."""
from ._read import gemm_seconds


def read(run):
    t = gemm_seconds(run)
    return 1e3 * t / run.units if t and run.units else None
