"""Online serving: continuous batching over a block-paged KV cache with
host and disk offload on real copy streams, and the fleet layer: an
N-replica router with KV migration and replica-kill fault tolerance
(DESIGN.md §16)."""
from .engine import (Engine, ServeConfig, Request, ServeStats,
                     ReloadPolicy, RELOAD_POLICY_NAMES, get_reload_policy,
                     ReplicaKilled, MigrationRefused, MigrationTicket,
                     naive_generate)
from .kv_cache import PagedKVCache
from .router import (Router, RouterStats, PLACEMENT_POLICY_NAMES,
                     PlacementPolicy, get_placement,
                     encode_ticket, decode_ticket)

__all__ = ["Engine", "ServeConfig", "Request", "ServeStats", "ReloadPolicy",
           "RELOAD_POLICY_NAMES", "get_reload_policy", "naive_generate",
           "ReplicaKilled", "MigrationRefused", "MigrationTicket",
           "PagedKVCache", "Router", "RouterStats",
           "PLACEMENT_POLICY_NAMES", "PlacementPolicy", "get_placement",
           "encode_ticket", "decode_ticket"]
