"""Block-paged KV cache: the serving-side MEMGRAPH memory discipline.

The port of ``repro/serve/kv_cache.py`` over torch tensors. The device
cache is the model's dense decode cache (``LM.init_cache``): every leaf is
laid out ``[L, B, S_max, ...]`` with batch *slots* on axis 1 and the token
axis (2) divided into fixed ``block_size``-token blocks. A
``(slot, block)`` pair names a fixed byte range for the whole serving run:
no allocation happens per token, and every transfer moves a whole extent.

* :meth:`read_block`   — the device slices of one block, for a d2h copy;
* :meth:`write_block`  — write one block back;
* :meth:`restore_slot` — write a resumed request's blocks 0..n-1;
* :meth:`drop_slot`    — zero a slot's extents when its request is swapped
  out, so a missed reload computes on zeros instead of stale bytes;
* :meth:`scatter_prefill` — write a batched prefill's ``[L, b, S, ...]``
  K/V into freshly admitted slots;
* :meth:`grow` — widen the slot axis to the next batch bucket (the only
  allocation, at admission boundaries, never per token).

Unlike the reference, whose jax arrays are immutable, the cache is written
**in place**: by these methods and by ``LM.decode_step``, all on the
engine's main loop, on the current (compute) stream. That is why a d2h
copy of a block may not simply start when the engine lock is released
(ROADMAP C3). On CUDA every write ends with :meth:`mark_written`, which
records an event on the compute stream; the engine's d2h stream waits on
the latest such event before it copies a block, so the copy reads the
block's final bytes. :meth:`grow` replaces the leaves; a copy in flight
holds references to the old leaves (the slices :meth:`read_block`
returned), so their memory outlives it.

Host copies of *cold* blocks stay valid for the lifetime of a request —
once a block's token range is fully behind the decode position it is never
rewritten — so a request preempted twice re-offloads only the tail block
that kept growing.
"""
from __future__ import annotations

import math

import torch

from ..core.bridge import dtype_name

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Device-side paged view over a dense decode cache (a dict of
    ``[L, B, S_max, ...]`` tensors on the model's device).

    Every method that writes must be called by the owning engine's main
    loop with its lock held; :meth:`read_block` returns views."""

    def __init__(self, model, bucket: int, max_len: int, *,
                 block_size: int = 32) -> None:
        if max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        self.model = model
        self.bucket = bucket
        self.max_len = max_len
        self.block_size = block_size
        self.cache: dict[str, torch.Tensor] = model.init_cache(bucket, max_len)
        for name, leaf in self.cache.items():
            if leaf.dim() < 3 or leaf.shape[1] != bucket \
                    or leaf.shape[2] != max_len:
                raise ValueError(
                    f"cache leaf {name!r} of shape {tuple(leaf.shape)} is not "
                    "[L, B, S, ...] token-paged: PagedKVCache supports the "
                    "attention families only")
        self.device = next(iter(self.cache.values())).device
        # CUDA event recorded on the compute stream after the latest write
        self.written: torch.cuda.Event | None = None
        self.n_blocks = max_len // block_size
        # bytes of one (slot, block) extent, summed over leaves (k, v, and
        # int8 scales when present)
        self.block_nbytes = sum(
            leaf.shape[0] * math.prod(leaf.shape[3:]) * block_size
            * leaf.element_size() for leaf in self.cache.values())

    # ------------------------------------------------------------ geometry
    def n_token_blocks(self, pos: int) -> int:
        """Blocks covering cache positions [0, pos)."""
        return -(-pos // self.block_size)

    def token_range(self, blk: int) -> tuple[int, int]:
        return blk * self.block_size, (blk + 1) * self.block_size

    def leaf_spec(self) -> dict[str, tuple[tuple[int, ...], str]]:
        """Per-leaf (shape, dtype name) of ONE block's payload,
        ``[L, block_size, ...]``: the contract a migration ticket is
        validated against before any byte lands on a replica. Dtypes are
        named as numpy names them (``"bfloat16"``, not ``"torch.bfloat16"``),
        so a ticket's header reads the same in the reference package."""
        return {k: ((leaf.shape[0], self.block_size) + tuple(leaf.shape[3:]),
                    dtype_name(leaf.dtype))
                for k, leaf in self.cache.items()}

    @property
    def token_nbytes(self) -> float:
        """Per-token KV bytes (offload-fraction denominator)."""
        return self.block_nbytes / self.block_size

    def mark_written(self) -> None:
        """Record, on the current stream, that every write so far is
        enqueued; a d2h copy waits on this event (no-op on the CPU)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.written = ev

    # ------------------------------------------------------------ extents
    def read_block(self, slot: int, blk: int) -> dict[str, torch.Tensor]:
        """The device slices ``[L, block_size, ...]`` of one block (views,
        no copy). A CUDA copy of them must first wait on :attr:`written`."""
        lo, hi = self.token_range(blk)
        return {k: leaf[:, slot, lo:hi] for k, leaf in self.cache.items()}

    def write_block(self, slot: int, blk: int,
                    data: dict[str, torch.Tensor]) -> None:
        lo, hi = self.token_range(blk)
        for k, leaf in self.cache.items():
            leaf[:, slot, lo:hi].copy_(data[k])
            self._used_here(data[k])
        self.mark_written()

    def restore_slot(self, slot: int,
                     blocks: list[dict[str, torch.Tensor]]) -> None:
        """Write a resumed request's reloaded blocks 0..n-1, one copy per
        leaf."""
        span = len(blocks) * self.block_size
        for k, leaf in self.cache.items():
            leaf[:, slot, :span].copy_(
                torch.cat([b[k] for b in blocks], dim=1))
            for b in blocks:
                self._used_here(b[k])
        self.mark_written()

    def drop_slot(self, slot: int) -> None:
        for leaf in self.cache.values():
            leaf[:, slot].zero_()
        self.mark_written()

    def scatter_prefill(self, slots: list[int],
                        kv: dict[str, torch.Tensor]) -> None:
        """Write prefill K/V (leaves [L, len(slots), S, ...]) into rows."""
        S = next(iter(kv.values())).shape[2]
        for k, leaf in self.cache.items():
            for i, slot in enumerate(slots):
                leaf[:, slot, :S].copy_(kv[k][:, i])
        self.mark_written()

    def grow(self, new_bucket: int) -> None:
        """Widen the slot axis. The old leaves are copied into the new ones
        and dropped here; a d2h copy still reading them holds its own
        references to them."""
        if new_bucket <= self.bucket:
            return
        new = self.model.init_cache(new_bucket, self.max_len)
        for k, leaf in self.cache.items():
            new[k][:, :self.bucket].copy_(leaf)
        self.cache = new
        self.bucket = new_bucket
        self.mark_written()

    def _used_here(self, t: torch.Tensor) -> None:
        """``t`` (a staging tensor the h2d stream allocated) is read on the
        current stream: the caching allocator must not hand its memory to
        the h2d stream again before this stream is done with it."""
        if t.device.type == "cuda":
            t.record_stream(torch.cuda.current_stream(t.device))
