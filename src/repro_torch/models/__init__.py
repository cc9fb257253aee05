"""Model zoo of the port: the decoder LM in its dense, MoE, RWKV6 and
Zamba2-hybrid families (``lm.py``, with the blocks of ``layers.py``,
``rwkv.py`` and ``ssm.py``) and the encoder-decoder backbone
(``encdec.py``)."""
from ..configs.base import ArchConfig
from .encdec import EncDec
from .lm import LM


def build_model(cfg: ArchConfig, **kw) -> LM | EncDec:
    """Factory: the model class for an architecture config. ``device`` and
    the model's options pass through: the LM's ``moe_capacity_factor``,
    ``remat`` and ``kv_cache_dtype``; EncDec's ``remat``."""
    if cfg.family == "encdec":
        return EncDec(cfg, **kw)
    return LM(cfg, **kw)


__all__ = ["LM", "EncDec", "build_model"]
