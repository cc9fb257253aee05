"""Model zoo of the port: the decoder LM, dense family (the MoE, RWKV6,
Zamba2 and enc-dec models wait for later slices)."""
from ..configs.base import ArchConfig
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> LM:
    """Factory: the model class for an architecture config (``device``
    and the LM's options pass through)."""
    if cfg.family == "encdec":
        raise NotImplementedError("EncDec is not ported yet")
    return LM(cfg, **kw)


__all__ = ["LM", "build_model"]
