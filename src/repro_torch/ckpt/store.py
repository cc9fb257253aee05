"""Sharded, digest-verified checkpointing: the port of ``repro/ckpt/store.py``.

The reference's API and on-disk layout, rewritten without JAX. Leaves are
tensors (on the card or the CPU) in nested dicts, keyed by their ``/``
paths in sorted order (``train/tree.py``), as the reference keys a pytree.
A leaf comes off the card to a host numpy array; a bfloat16 leaf is stored
as the reference's ``np.savez`` stores an ``ml_dtypes`` bfloat16 array, two
raw bytes an element (``'<V2'``), with ``"bfloat16"`` in the manifest, so
each side reads the other's checkpoints. Restore converts every leaf by the
manifest's dtype (never by numpy's) and places it on the device of the
matching leaf of ``tree_like``. The card machine has no ``ml_dtypes``, and
this module does not need it.

What follows is the reference's own description.

Layout: ``<dir>/step_<N>/`` containing ``shard_<i>.npz`` files plus
``MANIFEST.json`` (leaf paths, shapes, dtypes, per-leaf shard file,
per-file sha256, step, mesh-shape metadata). Leaves are packed greedily
into shards by a byte threshold (``shard_bytes``), so a large tree splits
across many files — parallel-writer friendly, and a corruption blast
radius of one shard. Writes are atomic (tmp dir + rename) so a failure
mid-write never corrupts the latest checkpoint; restore verifies every
needed shard's digest and, when no explicit step is requested, **falls
back to the newest complete checkpoint** if the latest one is corrupt or
truncated (fault-tolerance deliverable).

Elastic: arrays are stored unsharded by logical leaf (host gathers before
save); restore re-shards onto whatever mesh the new job brings, so scaling
from 256→512 chips (or CPU smoke) needs no conversion step.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import pathlib
import shutil
import sys
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from ..core import lockcheck
from ..train.tree import flatten, unflatten

__all__ = ["save_checkpoint", "save_checkpoint_async", "PendingCheckpoint",
           "restore_checkpoint", "latest_step", "complete_steps"]

DEFAULT_SHARD_BYTES = 64 * 2**20

# Serializes the publish + retention critical section across concurrent
# savers (an async checkpoint thread racing the supervisor's restart
# path): both mutate the same published step tree, and two overlapping
# prunes can race ``rmtree`` on the same directory. A SanitizedLock leaf,
# so checkpoint writes join the suite-wide lock-order audit.
_publish_lock = lockcheck.make_lock("CkptStore")

# The checkpoint disk-tier stream (DESIGN.md §15 / ROADMAP item 5 tail):
# one dedicated writer thread, mirroring the runtime's `disk` engine
# class. Blocking saves pipeline shard writes through it (leaf gather of
# shard i+1 overlaps the write of shard i); `save_checkpoint_async` runs
# the *whole* save on it so the training step loop never blocks on disk.
# Single-worker on purpose: shard writes of one checkpoint stay ordered,
# and concurrent saves serialize instead of thrashing one spindle.
_stream_lock = threading.Lock()
_stream: concurrent.futures.ThreadPoolExecutor | None = None


def _disk_stream() -> concurrent.futures.ThreadPoolExecutor:
    global _stream
    with _stream_lock:
        if _stream is None:
            _stream = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-disk")
        return _stream


def _write_shard(path: pathlib.Path, arrays: dict[str, np.ndarray]) -> None:
    """Write one shard file. A seam for fault-injection tests (a crash
    mid-shard-write must leave no partial checkpoint behind)."""
    np.savez(path, **arrays)


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    return flatten(tree)


def _host(leaf: Any) -> tuple[str, np.ndarray]:
    """(dtype name, host array as written): bfloat16 as raw 2-byte
    elements, the reference's ``'<V2'``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view("V2")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), arr


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype."""
    arr = np.array(arr)        # a contiguous copy that keeps 0-d leaves 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any,
                    *, meta: dict | None = None,
                    max_keep: int = 3,
                    shard_bytes: int = DEFAULT_SHARD_BYTES) -> pathlib.Path:
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=d, prefix=".tmp_"))
    try:
        return _save_into(d, tmp, step, tree, meta, max_keep, shard_bytes,
                          pipelined=True)
    except BaseException:
        # a crash mid-shard-write must not leak the partial tmp dir: the
        # published tree holds only complete, digest-covered checkpoints
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class PendingCheckpoint:
    """Handle to a checkpoint save running on the disk-tier stream."""

    def __init__(self, future: concurrent.futures.Future) -> None:
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None) -> pathlib.Path:
        """Block until the save publishes; returns the checkpoint dir.
        Re-raises any save failure (the tmp dir is already cleaned)."""
        return self._future.result(timeout)


def save_checkpoint_async(directory: str | os.PathLike, step: int, tree: Any,
                          *, meta: dict | None = None,
                          max_keep: int = 3,
                          shard_bytes: int = DEFAULT_SHARD_BYTES,
                          ) -> PendingCheckpoint:
    """Non-blocking :func:`save_checkpoint`: the whole save (leaf gather,
    shard writes, digests, atomic publish) runs on the disk-tier stream so
    the training step loop overlaps checkpointing instead of stalling on
    it. Sound because the port's train step replaces the state's tensors and
    never writes into them, so the tree being written is a snapshot; the
    leaves are read after an event recorded on the caller's stream. The
    publish + retention critical section still serializes against
    concurrent blocking saves under ``_publish_lock``.

    The save runs inline on the stream worker (not re-submitted shard by
    shard): the stream is single-worker, so a save that queued its own
    shard writes behind itself would deadlock."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=d, prefix=".tmp_"))
    ready = None
    if any(isinstance(v, torch.Tensor) and v.is_cuda
           for _, v in _leaf_paths(tree)):
        ready = torch.cuda.Event()
        ready.record()

    def _job() -> pathlib.Path:
        if ready is not None:
            ready.synchronize()
        try:
            return _save_into(d, tmp, step, tree, meta, max_keep,
                              shard_bytes, pipelined=False)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    return PendingCheckpoint(_disk_stream().submit(_job))


def _save_into(d: pathlib.Path, tmp: pathlib.Path, step: int, tree: Any,
               meta: dict | None, max_keep: int, shard_bytes: int, *,
               pipelined: bool) -> pathlib.Path:
    leaves = _leaf_paths(tree)

    # ``pipelined``: shard writes ride the disk-tier stream as each shard
    # closes, so the device→host gather of shard i+1 overlaps the write
    # of shard i. The async path passes False — it already *is* the
    # stream worker, and the stream is single-worker.
    futures: list[concurrent.futures.Future] = []

    def _flush(group: list[tuple[str, str, np.ndarray]], si: int) -> None:
        path = tmp / f"shard_{si}.npz"
        arrays = {idx: arr for idx, _key, arr in group}
        if pipelined:
            # late-bind _write_shard so test fault injection (monkeypatch
            # of the module global) reaches stream-side writes too
            futures.append(_disk_stream().submit(
                lambda: _write_shard(path, arrays)))
        else:
            _write_shard(path, arrays)

    # greedy size-threshold packing: a shard closes once adding the next
    # leaf would push it past shard_bytes (oversized single leaves get a
    # shard of their own)
    shards: list[list[tuple[str, str, np.ndarray]]] = []
    cur: list[tuple[str, str, np.ndarray]] = []
    cur_bytes = 0
    dtypes: dict[str, str] = {}
    for i, (key, leaf) in enumerate(leaves):
        dtypes[key], arr = _host(leaf)
        if cur and cur_bytes + arr.nbytes > shard_bytes:
            shards.append(cur)
            _flush(cur, len(shards) - 1)
            cur, cur_bytes = [], 0
        cur.append((f"a{i}", key, arr))
        cur_bytes += arr.nbytes
    if cur:
        shards.append(cur)
        _flush(cur, len(shards) - 1)

    # drain the stream before digesting: every write must land first, and
    # on failure the rest are cancelled (best effort — one may already be
    # running) then waited out, so no late write races the caller's
    # tmp-dir cleanup
    errors: list[BaseException] = []
    for f in futures:
        if errors and f.cancel():
            continue
        try:
            f.result()
        except concurrent.futures.CancelledError:
            pass
        except BaseException as e:
            errors.append(e)
    if errors:
        raise errors[0]

    files: dict[str, str] = {}
    manifest_leaves: list[dict] = []     # shard packing preserves leaf order
    for si, group in enumerate(shards):
        fname = f"shard_{si}.npz"
        path = tmp / fname
        files[fname] = hashlib.sha256(path.read_bytes()).hexdigest()
        for idx, key, arr in group:
            # reuse the already-materialized array: a second np.asarray
            # per leaf would repeat the whole device→host gather
            manifest_leaves.append({"key": key, "idx": idx, "file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": dtypes[key]})

    manifest = {
        "step": int(step),
        "meta": meta or {},
        "leaves": manifest_leaves,
        "files": files,
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    final = d / f"step_{step:010d}"
    with _publish_lock:
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)   # atomic publish
        # retention
        steps = sorted(p for p in d.iterdir() if p.name.startswith("step_"))
        for old in steps[:-max_keep]:
            shutil.rmtree(old)
    return final


def complete_steps(directory: str | os.PathLike) -> list[int]:
    """Steps with a parseable manifest whose every shard exists and passes
    its digest, ascending."""
    d = pathlib.Path(directory)
    if not d.exists():
        return []
    out = []
    for p in sorted(d.iterdir()):
        if not p.name.startswith("step_"):
            continue
        try:
            _verify(p)
        except Exception:
            continue
        out.append(int(p.name.split("_")[1]))
    return out


def latest_step(directory: str | os.PathLike) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    best = None
    for p in sorted(d.iterdir()):
        if p.name.startswith("step_") and (p / "MANIFEST.json").exists():
            best = int(p.name.split("_")[1])
    return best


def _verify(cdir: pathlib.Path) -> dict:
    """Parse a checkpoint's manifest and verify every shard digest."""
    manifest = json.loads((cdir / "MANIFEST.json").read_text())
    for fname, want in manifest["files"].items():
        shard = cdir / fname
        if not shard.exists():
            raise IOError(f"checkpoint corruption: missing shard {shard}")
        got = hashlib.sha256(shard.read_bytes()).hexdigest()
        if got != want:
            raise IOError(f"checkpoint corruption in {shard}: "
                          f"sha256 {got} != {want}")
    return manifest


def _load(cdir: pathlib.Path, tree_like: Any,
          manifest: dict | None = None) -> tuple[Any, int]:
    if manifest is None:           # fallback path verified (+parsed) already
        manifest = _verify(cdir)
    # group leaves by shard so each file is opened once
    by_file: dict[str, list[dict]] = {}
    for leaf in manifest["leaves"]:
        # pre-sharding manifests (one monolithic shard) carry no file field
        by_file.setdefault(leaf.get("file", "shard_0.npz"), []).append(leaf)
    by_key: dict[str, torch.Tensor] = {}
    for fname, leaves in by_file.items():
        with np.load(cdir / fname) as data:
            for leaf in leaves:
                by_key[leaf["key"]] = _tensor(data[leaf["idx"]],
                                              leaf["dtype"])
    flat = _leaf_paths(tree_like)
    out = []
    for key, like in flat:
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = by_key[key]
        want_shape = tuple(np.shape(like))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"leaf {key!r}: ckpt {tuple(arr.shape)} != "
                             f"expected {want_shape}")
        if isinstance(like, torch.Tensor):
            arr = arr.to(like.device)
        out.append(arr)
    return unflatten(tree_like, out), manifest["step"]


def restore_checkpoint(directory: str | os.PathLike, tree_like: Any,
                       *, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like``; verify digests; place
    each leaf on the device of ``tree_like``'s leaf (a tensor), as the
    reference places leaves on its ``shardings``.

    With an explicit ``step``, corruption raises. With ``step=None`` the
    newest checkpoint is tried first and, if its shards/manifest fail
    verification (a crash mid-write, bit rot), restore falls back to the
    next-newest *complete* step — the restart driver never wedges on a bad
    latest checkpoint. Shape/structure mismatches against ``tree_like``
    never fall back: they mean the caller asked for the wrong tree."""
    d = pathlib.Path(directory)
    if step is not None:
        return _load(d / f"step_{step:010d}", tree_like)
    candidates = sorted((p for p in d.iterdir()
                         if p.name.startswith("step_")),
                        reverse=True) if d.exists() else []
    if not candidates:
        raise FileNotFoundError(f"no checkpoint under {d}")
    errors: list[str] = []
    for cdir in candidates:
        try:
            manifest = _verify(cdir)
        except Exception as e:          # truncated/corrupt: try the next
            errors.append(f"{cdir.name}: {e}")
            print(f"ckpt: skipping {cdir.name} ({e}); falling back",
                  file=sys.stderr)
            continue
        # shape/structure errors below must surface, never fall back
        return _load(cdir, tree_like, manifest)
    raise IOError("checkpoint corruption: no intact checkpoint under "
                  f"{d}; tried {'; '.join(errors)}")
