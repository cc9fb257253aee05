"""Deterministic sharded data pipeline: a copy of ``repro/data/pipeline.py``
(numpy only), so that the port imports nothing of the reference package;
its batches are byte for byte the reference's.

Production shape without external deps: a seeded synthetic token stream
(shift-register LM task — next token is a function of the previous ones, so
a real model can actually reduce loss on it), sharded by (host, step) with
O(1) skip-to-step for restart/elastic-rescale: batch contents depend only on
``(seed, step, global_batch)`` — never on worker count — so a checkpoint
restored at step N on a *different* topology still sees the same stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLMStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLMStream:
    """batch(step, shard, n_shards) -> {'tokens','labels'} for that shard."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg

    def _sequence(self, idx: np.ndarray) -> np.ndarray:
        """Deterministic per-sample token sequence [len = seq_len + 1]."""
        cfg = self.cfg
        n = cfg.seq_len + 1
        rng_mat = np.arange(n, dtype=np.int64)[None, :]
        base = (idx[:, None] * 1_000_003 + cfg.seed * 7_777_777) % (2**31 - 1)
        x = (base + rng_mat * 69_069) % (2**31 - 1)
        # shift-register structure: token_t mixes token_{t-1}'s residue
        toks = np.zeros((len(idx), n), np.int64)
        toks[:, 0] = x[:, 0] % cfg.vocab_size
        for t in range(1, n):
            toks[:, t] = (toks[:, t - 1] * 31 + x[:, t]) % cfg.vocab_size
        return toks

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        per = cfg.global_batch // n_shards
        first = step * cfg.global_batch + shard * per
        idx = np.arange(first, first + per, dtype=np.int64)
        toks = self._sequence(idx)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
