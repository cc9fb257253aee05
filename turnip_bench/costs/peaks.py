"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), the rates at which the kernel table prices
its bounds."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_FLOPS = 67e12              # float32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16/f16 tensor cores, dense
TF32_FLOPS = 495e12            # TF32 tensor cores, dense
# float32-accurate products on the tensor cores: 3xTF32 runs three TF32
# products (hi*hi + hi*lo + lo*hi) for each float32 one
F32_TC_FLOPS = TF32_FLOPS / 3


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time for ``ops`` operations at ``peak`` and ``nbytes`` at
    the memory rate: the larger of the two, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
