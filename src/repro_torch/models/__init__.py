"""Model zoo of the port: the decoder LM in its dense, MoE, RWKV6 and
Zamba2-hybrid families (``lm.py``, with the blocks of ``layers.py``,
``rwkv.py`` and ``ssm.py``). The enc-dec model waits for a later slice."""
from ..configs.base import ArchConfig
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> LM:
    """Factory: the model class for an architecture config (``device``
    and the LM's options, ``moe_capacity_factor``, ``remat`` and
    ``kv_cache_dtype``, pass through)."""
    if cfg.family == "encdec":
        raise NotImplementedError("EncDec is not ported yet")
    return LM(cfg, **kw)


__all__ = ["LM", "build_model"]
