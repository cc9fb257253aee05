"""The synthetic token stream, frozen: a copy of the arithmetic of
``repro_torch/data/pipeline.py::SyntheticLMStream`` (numpy only), so that
a change to the program cannot move the benchmark's inputs.

Row ``i`` of a stream with seed ``seed`` is a shift-register sequence:
``x_t = (base_i + 69069 t) mod (2^31 - 1)``, ``tok_0 = x_0 mod V`` and
``tok_t = (31 tok_{t-1} + x_t) mod V``, with ``base_i = (1000003 i + 7777777
seed) mod (2^31 - 1)``. The program's stream gives the same rows for the
same (seed, index).
"""
from __future__ import annotations

import numpy as np

__all__ = ["rows", "train_batches"]

_M = 2**31 - 1


def rows(first: int, n: int, length: int, vocab: int, seed: int) -> np.ndarray:
    """Rows ``first .. first + n - 1`` of the stream, ``length`` tokens
    each, int64 [n, length]."""
    idx = np.arange(first, first + n, dtype=np.int64)
    t = np.arange(length, dtype=np.int64)[None, :]
    base = (idx[:, None] * 1_000_003 + (int(seed) % _M) * 7_777_777) % _M
    x = (base + t * 69_069) % _M
    toks = np.zeros((n, length), np.int64)
    toks[:, 0] = x[:, 0] % vocab
    for j in range(1, length):
        toks[:, j] = (toks[:, j - 1] * 31 + x[:, j]) % vocab
    return toks


def train_batches(n_batches: int, batch: int, seq_len: int, vocab: int,
                  seed: int) -> list[dict]:
    """The first ``n_batches`` batches of ``batch`` rows each:
    ``{"tokens", "labels"}`` int32 [batch, seq_len], labels the tokens
    shifted by one. Every row is a different row of the stream."""
    toks = rows(0, n_batches * batch, seq_len + 1, vocab, seed)
    return [{"tokens": toks[i * batch:(i + 1) * batch, :-1].astype(np.int32),
             "labels": toks[i * batch:(i + 1) * batch, 1:].astype(np.int32)}
            for i in range(n_batches)]
