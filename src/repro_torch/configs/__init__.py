"""Config registry: the 10 assigned architectures + the paper's LLaMA models.

``get_arch(name)`` resolves any registered ``--arch <id>``.
"""
from .base import (ArchConfig, ShapeConfig, SHAPES, reduced,
                   applicable_shapes)

from .internvl2_26b import CONFIG as internvl2_26b
from .zamba2_7b import CONFIG as zamba2_7b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .starcoder2_3b import CONFIG as starcoder2_3b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .olmo_1b import CONFIG as olmo_1b
from .qwen1_5_32b import CONFIG as qwen1_5_32b
from .granite_moe_1b import CONFIG as granite_moe_1b
from .moonshot_16b import CONFIG as moonshot_16b
from .seamless_m4t_large import CONFIG as seamless_m4t_large
from .llama_7b import CONFIG as llama_7b
from .llama_65b import CONFIG as llama_65b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        internvl2_26b, zamba2_7b, rwkv6_7b, starcoder2_3b, qwen2_5_3b,
        olmo_1b, qwen1_5_32b, granite_moe_1b, moonshot_16b,
        seamless_m4t_large, llama_7b, llama_65b,
    )
}
ASSIGNED = [n for n in ARCHS if not n.startswith("llama")]


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}"
                       ) from None


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "ASSIGNED",
           "get_arch", "reduced", "applicable_shapes"]
