"""Online serving: continuous batching over a block-paged KV cache with
host and disk offload on real copy streams. The fleet layer (router, KV
migration, replica faults) waits for a later slice."""
from .engine import (Engine, ServeConfig, Request, ServeStats,
                     ReloadPolicy, RELOAD_POLICY_NAMES, get_reload_policy,
                     naive_generate)
from .kv_cache import PagedKVCache

__all__ = ["Engine", "ServeConfig", "Request", "ServeStats", "ReloadPolicy",
           "RELOAD_POLICY_NAMES", "get_reload_policy", "naive_generate",
           "PagedKVCache"]
