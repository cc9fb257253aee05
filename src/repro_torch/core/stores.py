"""The storage hierarchy behind the MEMGRAPH runtime and the serving engine.

TURNIP's premise is that "inexpensive CPU RAM is used to increase the amount
of storage available" — but CPU RAM is itself finite, and online serving
workloads (NEO, PAPERS.md) hit the host-RAM ceiling first. This module
models the full hierarchy::

    device HBM  --d2h/h2d-->  host RAM (pinned arena)  --disk I/O-->  disk

* :class:`HostStore` — the unbounded pinned host arena (paper §B
  ``cudaHostAlloc``): graph inputs + offloaded tensors, with traffic,
  occupancy, and peak counters.
* :class:`DiskStore` — the next rung: a file-backed blob store (one
  append-only ``spill.log``; framed records, in-memory index) with its
  own traffic/occupancy/peak counters and an optional byte ``capacity``.
  Disk is the *last* tier: there is nowhere further to evict, so an
  admission that would overflow the capacity is **refused** with a typed
  :class:`DiskFullError` rather than silently growing (the compile-time
  feasibility check in ``build.py`` makes this unreachable for compiled
  plans; serving and standalone users get the prompt error instead of an
  unbounded tier). A record that has been torn or bit-rotted raises
  :class:`DiskCorruptionError` — promptly, on the disk stream, never a
  hang.
* :class:`TieredStore` — a :class:`HostStore` whose offload arena is
  capacity-bounded and backed by a :class:`DiskStore`. Victims can be
  chosen two ways, matching the compiler/runtime split:

  - **plan-driven** (the MEMGRAPH path): ``host_capacity=None`` and the
    compiled plan's SPILL/LOAD vertices call :meth:`spill`/:meth:`load`
    explicitly — the compiler already chose victims Belady-optimally over
    the serialized schedule (``build.py``);
  - **auto-LRU** (the serving path, or standalone use): ``host_capacity``
    set and ``auto_spill=True`` spills the least-recently-touched keys on
    overflow — at runtime the future is unknown, so recency is the best
    available signal. The serving engine instead sets ``auto_spill=False``
    and drives spills through a dedicated disk DMA stream so the I/O cost
    lands on a timeline, not inside ``put_offload``.

Tier choice must never change results, only timing: :meth:`get_offload`
reads *through* to disk, so a value is always recoverable no matter which
tier currently holds its bytes.

In the port the host tier is real pinned memory. On a CUDA store every
host tensor is page-locked (``pin_memory``, the paper's ``cudaHostAlloc``):
a ``non_blocking`` copy from pageable memory would quietly run
synchronously, so every CUDA path asserts ``is_pinned()``. An offload
copies the device extent into a fresh pinned tensor with
``copy_(non_blocking=True)`` on the caller's stream (the runtime's d2h
stream); a reload hands the pinned tensor to the memory backend, which
copies it into the extent on the caller's h2d stream. The caller makes the
copy complete before anyone reads its result (the executor's
event-synchronised completion). A CPU store holds plain tensors. The disk
tier goes through numpy at the file boundary and keeps the reference's
``spill.log`` framing.
"""
from __future__ import annotations

import os
import pathlib
import shutil
import struct
import tempfile
from typing import Any

import torch

from . import lockcheck
from .bridge import host_tensor, numpy_bytes, tensor_from_bytes
from .device import resolve_device

__all__ = ["HostStore", "DiskStore", "TieredStore", "DiskFullError",
           "DiskCorruptionError"]


class DiskFullError(RuntimeError):
    """An admission would exceed the disk tier's capacity. Disk is the last
    rung of the hierarchy — there is no further tier to evict to — so the
    write is refused instead of silently overflowing the budget."""


class DiskCorruptionError(IOError):
    """A spilled blob's backing file is missing or unreadable (truncated,
    deleted, bit-rotted). Raised promptly by :meth:`DiskStore.get` so a
    disk-stream LOAD fails fast instead of wedging its consumers."""


def _nbytes(value) -> int:
    """Total bytes of a tensor or a flat dict of tensors (a KV block)."""
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return value.nbytes


class HostStore:
    """Host (CPU-RAM) storage: graph inputs + offloaded tensors.

    Keys are opaque hashables: the MEMGRAPH runtime offloads under its
    OFFLOAD vertex mids, and the serving engine (:mod:`repro.serve`) uses
    the same arena class with ``(request, block)`` keys (pass one store to
    both to share a single pinned pool and traffic counters).
    ``offload_bytes``/``reload_bytes`` count cumulative d2h/h2d traffic;
    ``resident_bytes`` is current occupancy and ``peak_resident_bytes``
    its high-water mark.

    ``device`` is the device whose extents the store feeds (default
    CUDA). ``inputs`` may be numpy arrays (converted, and pinned for a
    CUDA store) or CPU tensors, which a CUDA store requires pinned."""

    def __init__(self, inputs: dict[int, Any], *,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.pinned = self.device.type == "cuda"
        self.inputs = {t: host_tensor(v, pin=self.pinned)
                       for t, v in inputs.items()}
        self.offloaded: dict[Any, Any] = {}
        self.offload_bytes = 0
        self.reload_bytes = 0
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        # lock class = concrete type: TieredStore code paths hold this
        # lock around DiskStore and HostPool calls, and the lock-order
        # sanitizer (lockcheck.py) checks those pairs stay acyclic
        self._lock = lockcheck.make_lock(type(self).__name__)

    # subclass hooks (no-ops here) -------------------------------------
    def _touch(self, key) -> None:
        """Record a use of ``key`` for recency-based victim choice."""

    def _admit_locked(self, key, *, fresh: bool = True) -> None:
        """Called (lock held) after ``key`` lands in the host arena.
        ``fresh`` distinguishes a new write (which supersedes any older
        copy on a lower tier) from a disk→host staging (whose disk copy
        stays authoritative)."""

    def _account_locked(self, delta: int) -> None:
        """Called (lock held) on every ``resident_bytes`` change — the
        seam a pool :class:`~repro_torch.core.pool.Lease` mirrors occupancy
        through."""

    def _host_copy(self, value):
        """A host copy of ``value`` (a tensor or flat dict of tensors). A
        device tensor is copied into a fresh pinned tensor with a
        ``non_blocking`` copy on the current stream: the d2h leg of an
        offload, complete once the caller's stream has reached it."""
        if isinstance(value, dict):
            return {k: self._host_copy(v) for k, v in value.items()}
        buf = torch.empty(value.shape, dtype=value.dtype,
                          pin_memory=self.pinned)
        buf.copy_(value, non_blocking=self.pinned)
        return buf

    def _check_pinned(self, value) -> None:
        """Every host tensor a CUDA store hands to an h2d copy is pinned:
        a non_blocking copy from pageable memory is quietly synchronous."""
        if self.pinned:
            vals = value.values() if isinstance(value, dict) else (value,)
            for v in vals:
                assert v.is_pinned(), "CUDA host store holds a pageable tensor"

    def put_offload(self, key, value, *, copy: bool = True) -> None:
        """Store a host copy of an offloaded tensor (or flat dict of
        tensors — a serving KV block) under ``key``; counts d2h traffic +
        occupancy. ``copy=False`` hands over a host copy the caller already
        made with :meth:`_host_copy` and completed (the serving engine's
        d2h stream does the copy itself, off the engine lock)."""
        if copy:
            value = self._host_copy(value)
        else:
            self._check_pinned(value)
        n = _nbytes(value)
        with self._lock:
            prev = self.offloaded.get(key)
            prev_n = _nbytes(prev) if prev is not None else 0
            self.offloaded[key] = value
            self.offload_bytes += n
            self.resident_bytes += n - prev_n
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes)
            self._account_locked(n - prev_n)
            self._admit_locked(key)

    def get_offload(self, key):
        """Fetch an offloaded value for reload; counts h2d traffic."""
        with self._lock:
            val = self.offloaded[key]
            self.reload_bytes += _nbytes(val)
            self._touch(key)
        self._check_pinned(val)
        return val

    def pop_offload(self, key) -> None:
        """Free a host copy (no traffic: dead data is simply released)."""
        with self._lock:
            val = self.offloaded.pop(key, None)
            if val is not None:
                self.resident_bytes -= _nbytes(val)
                self._account_locked(-_nbytes(val))

    def peek_offload(self, key):
        """Read a value without counting traffic (final-output collection).
        Returns ``None`` when no copy exists on any tier."""
        with self._lock:
            return self.offloaded.get(key)

    def tier_of(self, key) -> str | None:
        """Which tier currently holds ``key``'s bytes (``None`` = nowhere)."""
        with self._lock:
            return "host" if key in self.offloaded else None

    def get_for_reload(self, v) -> torch.Tensor:
        """RELOAD vertex read: the offloaded copy (operands[0] is the host
        key) or the immutable input store. The caller copies it into the
        device extent on its h2d stream."""
        if v.operands:
            return self.get_offload(v.operands[0])
        with self._lock:
            val = self.inputs[v.src_tid]       # immutable input store
            self.reload_bytes += _nbytes(val)
        self._check_pinned(val)
        return val

    def get_input(self, tid: int) -> torch.Tensor:
        """INPUT vertex read: a graph input (no traffic counted, as in the
        reference)."""
        val = self.inputs[tid]
        self._check_pinned(val)
        return val

    def close(self) -> None:
        """Release any backing resources (no-op for a pure host store)."""


class DiskStore:
    """File-backed blob store — the disk tier of the hierarchy.

    All blobs live in a single append-only log (``spill.log`` under
    ``directory``, a private temp dir by default, removed on
    :meth:`close`). A file per key would pay an open/create/close
    round-trip (~150 us of syscalls) on every spill — two orders of
    magnitude more than the write itself for KB-scale tensors — so the
    store keeps one write handle open and appends framed records: a
    12-byte header (magic + payload length) followed by the raw array
    bytes. Reads are positioned ``pread`` calls on a second handle; the
    frame turns truncation or bit-rot into a prompt
    :class:`DiskCorruptionError` instead of garbage bytes. Values are
    CPU tensors or flat dicts of them (serving KV blocks), written as
    raw bytes through numpy; dtype/shape
    live in the in-memory index — the log holds bytes only, so nothing
    about a record can be recovered without its index entry and the
    store is scoped to one process lifetime, exactly like the device
    arena it backs.

    ``write_bytes``/``read_bytes`` count cumulative spill/load traffic;
    ``resident_bytes``/``peak_resident_bytes`` track *live* occupancy.
    :meth:`drop` retires a record logically (the capacity check frees
    its bytes immediately). The physical log space of retired records is
    reclaimed by **compaction**: when dead bytes dominate the log
    (``compact_dead_fraction`` of the file, once it exceeds
    ``compact_min_bytes``), the live records are streamed into a fresh
    log which atomically replaces the old one (``os.replace``), under
    the same store lock every mutation already holds. A crash at any
    instant leaves either the complete old log or the complete new one —
    never a torn mixture — and in-flight readers holding the old read
    handle retry against the new index (a generation counter guards the
    swap). ``capacity`` (bytes, ``None`` = unbounded) makes :meth:`put`
    refuse admissions that would overflow the tier with a
    :class:`DiskFullError` — overwriting an existing key only charges
    the delta."""

    _ARR = "__arr__"              # spec field name for a bare-tensor value
    _MAGIC = b"TNIP"
    _HDR = struct.Struct("<4sQ")  # record frame: magic, payload nbytes

    def __init__(self, directory: str | os.PathLike | None = None, *,
                 capacity: int | None = None,
                 compact_dead_fraction: float | None = 0.5,
                 compact_min_bytes: int = 1 << 20) -> None:
        self._dir = pathlib.Path(directory) if directory is not None else None
        self._owns_dir = directory is None
        self.capacity = capacity
        # compaction knobs: rewrite the log once dead bytes exceed this
        # fraction of the file (None disables), but never bother below
        # the size floor (small logs are cheaper to leave alone)
        self.compact_dead_fraction = compact_dead_fraction
        self.compact_min_bytes = compact_min_bytes
        # key -> (log offset, payload nbytes, ((name, dtype, shape, nb), ...))
        self._files: dict[Any, tuple[int, int, tuple]] = {}
        self._log_path: pathlib.Path | None = None
        self._wfd: int | None = None
        self._rfd: int | None = None
        self._end = 0                 # next append offset
        self.write_bytes = 0
        self.read_bytes = 0
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        # dead (retired-record) bytes currently wasting log space,
        # frame headers included — what compaction reclaims
        self.dead_bytes = 0
        self.n_compactions = 0
        self.compacted_reclaimed_bytes = 0
        # bumped on every log rewrite: readers that resolved an index
        # entry against an older generation retry their read
        self._gen = 0
        # read handles retired by compaction: a reader may be mid-pread
        # on one, so they stay open until close()
        self._retired_fds: list[int] = []
        self._lock = lockcheck.make_lock("DiskStore")

    def _root(self) -> pathlib.Path:
        if self._dir is None:
            self._dir = pathlib.Path(tempfile.mkdtemp(prefix="turnip-disk-"))
        else:
            self._dir.mkdir(parents=True, exist_ok=True)
        return self._dir

    def _open_log(self) -> None:
        """Open (or reopen after :meth:`close`) the log pair: an append
        write handle and a positioned-read handle. Call with the lock."""
        if self._wfd is None:
            path = self._root() / "spill.log"
            self._log_path = path
            self._wfd = os.open(str(path),
                                os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            self._rfd = os.open(str(path), os.O_RDONLY)
            self._end = os.fstat(self._wfd).st_size

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._files

    def put(self, key, value) -> int:
        """Append ``key``'s bytes to the log; returns the payload size.
        Raises :class:`DiskFullError` when a ``capacity`` is set and
        admitting the bytes would overflow it (the write is refused,
        nothing changes). A re-put appends a fresh record and retires
        the old one — records are immutable once written, which is what
        makes the lock-free positioned reads in :meth:`get` safe."""
        payload = value if isinstance(value, dict) else {self._ARR: value}
        arrays = {k: numpy_bytes(v) for k, v in payload.items()}
        spec = tuple((k, dt, tuple(payload[k].shape), a.nbytes)
                     for k, (dt, a) in arrays.items())
        blob = b"".join(a.tobytes() for _, a in arrays.values())
        n = len(blob)
        rec = self._HDR.pack(self._MAGIC, n) + blob
        with self._lock:
            prev_entry = self._files.get(key)
            prev = prev_entry[1] if prev_entry is not None else 0
            if (self.capacity is not None
                    and self.resident_bytes - prev + n > self.capacity):
                raise DiskFullError(
                    f"disk tier full: {n} B for {key!r} would push occupancy "
                    f"{self.resident_bytes - prev} B past capacity "
                    f"{self.capacity} B")
            self._open_log()
            assert self._wfd is not None
            off = self._end
            os.write(self._wfd, rec)
            self._end = off + len(rec)
            self._files[key] = (off, n, spec)
            self.write_bytes += n
            self.resident_bytes += n - prev
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes)
            if prev_entry is not None:   # the old record is now dead space
                self.dead_bytes += self._HDR.size + prev
                self._maybe_compact_locked()
        return n

    def _read_blob(self, entry: tuple[int, int, tuple]):
        """The raw positioned read + frame check (a test seam for
        fault/race injection)."""
        off, n, spec = entry
        rfd = self._rfd
        if rfd is None:
            raise ValueError("spill log is not open")
        hdr = os.pread(rfd, self._HDR.size, off)
        if len(hdr) != self._HDR.size:
            raise ValueError("torn record header")
        magic, length = self._HDR.unpack(hdr)
        if magic != self._MAGIC or length != n:
            raise ValueError("bad record frame")
        buf = os.pread(rfd, n, off + self._HDR.size)
        if len(buf) != n:
            raise ValueError("torn record payload")
        out = {}
        at = 0
        for name, dt, shape, nb in spec:
            out[name] = tensor_from_bytes(buf[at:at + nb], dt, shape)
            at += nb
        if set(out) == {self._ARR}:
            return out[self._ARR]
        return out

    def get(self, key, *, count: bool = True):
        """Read ``key``'s blob back. An unknown key raises ``KeyError``; a
        known key whose log record is torn or unreadable raises
        :class:`DiskCorruptionError` immediately (fail fast on the disk
        stream — a LOAD must never hang its consumers on rotten bytes).

        The index entry is resolved under the lock but the record is
        read outside it (so slow I/O never serializes the tier). Records
        are immutable, so a concurrent re-put cannot tear the read — but
        a concurrent :meth:`drop` retires the entry mid-read. That is a
        healthy, legitimately-freed key — not corruption — so the read
        re-checks the entry afterwards and raises ``KeyError`` for the
        dropped-key case instead of returning retired bytes. A
        concurrent *compaction* instead moves the live record to a new
        offset in a rewritten log; the generation counter detects that
        and the read retries against the new index — even when the
        stale-offset read happened to return frame-valid bytes, which
        after a rewrite could be the wrong record's."""
        while True:
            with self._lock:
                entry = self._files[key]
                gen = self._gen
                if count:
                    self.read_bytes += entry[1]
                    count = False      # one logical load, however many tries
            try:
                val = self._read_blob(entry)
            except (OSError, EOFError, ValueError) as e:
                with self._lock:
                    cur = self._files.get(key)
                    cur_gen = self._gen
                if cur_gen != gen:
                    continue           # log rewritten mid-read: retry
                if cur is None or cur[0] != entry[0]:
                    # drop/get race: the key was freed (or freed and
                    # re-put — a re-put always appends at a fresh offset)
                    # while we read the old record. The caller raced a
                    # legitimate release; the tier is healthy: a stale
                    # lookup, not corruption.
                    raise KeyError(key) from None
                raise DiskCorruptionError(
                    f"spill record for {key!r} torn or corrupt at "
                    f"{self._log_path}+{entry[0]}: {e}") from e
            with self._lock:
                cur = self._files.get(key)
                cur_gen = self._gen
            if cur_gen != gen:
                continue               # log rewritten mid-read: retry
            if cur is None or cur[0] != entry[0]:
                raise KeyError(key)
            return val

    def drop(self, key) -> None:
        with self._lock:
            entry = self._files.pop(key, None)
            if entry is None:
                return
            self.resident_bytes -= entry[1]
            self.dead_bytes += self._HDR.size + entry[1]
            self._maybe_compact_locked()

    # ---- log compaction ----------------------------------------------
    def _maybe_compact_locked(self) -> None:
        """Lock held. Kick a compaction when dead bytes dominate the log.
        Compaction is an *optimization*: any failure (I/O error, a torn
        record in a log region we were about to discard anyway) leaves
        the store fully functional on the old log, so errors are
        swallowed here — the put/drop that triggered the pass must not
        fail for it."""
        if (self._wfd is None or self.compact_dead_fraction is None
                or self._end < self.compact_min_bytes
                or self.dead_bytes <
                self.compact_dead_fraction * self._end):
            return
        try:
            self._compact_locked()
        except (OSError, ValueError):
            pass

    def _publish_compaction(self, tmp: pathlib.Path,
                            path: pathlib.Path) -> None:
        """The commit point: atomically swap the rewritten log into
        place. A crash strictly before leaves the old log intact (plus a
        stray tmp file); strictly after, the new log is complete and
        fsynced. Split out as a fault-injection seam for the
        crash-during-compaction tests."""
        os.replace(tmp, path)

    def _compact_locked(self) -> None:
        """Lock held. Stream the live records into a fresh log, fsync,
        atomically publish, and swap the in-memory index to the new
        offsets. The old read handle is retired, not closed: a
        concurrent :meth:`get` may be mid-``pread`` on it (it will see
        intact old-log bytes, notice the generation bump, and retry
        against the new index)."""
        assert self._log_path is not None and self._rfd is not None \
            and self._wfd is not None
        old_rfd, old_wfd, old_end = self._rfd, self._wfd, self._end
        tmp = self._log_path.with_name(self._log_path.name + ".compact")
        entries = sorted(self._files.items(), key=lambda kv: kv[1][0])
        tfd: int | None = os.open(str(tmp),
                                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                                  0o644)
        try:
            new_files: dict[Any, tuple[int, int, tuple]] = {}
            at = 0
            for key, (off, n, spec) in entries:
                hdr = os.pread(old_rfd, self._HDR.size, off)
                if len(hdr) != self._HDR.size:
                    raise ValueError("torn record header")
                magic, length = self._HDR.unpack(hdr)
                if magic != self._MAGIC or length != n:
                    raise ValueError("bad record frame")
                buf = os.pread(old_rfd, n, off + self._HDR.size)
                if len(buf) != n:
                    raise ValueError("torn record payload")
                os.write(tfd, hdr + buf)
                new_files[key] = (at, n, spec)
                at += self._HDR.size + n
            os.fsync(tfd)
            os.close(tfd)
            tfd = None
            self._publish_compaction(tmp, self._log_path)
        except BaseException:
            # abort: the old log (and every handle on it) is untouched
            if tfd is not None:
                os.close(tfd)
            tmp.unlink(missing_ok=True)
            raise
        # committed on disk — swap handles and index. The old fds keep
        # the pre-replace inode alive for any mid-read concurrent get.
        self._wfd = os.open(str(self._log_path),
                            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            self._rfd = os.open(str(self._log_path), os.O_RDONLY)
        except BaseException:
            os.close(self._wfd)
            self._wfd, self._rfd = old_wfd, old_rfd
            raise
        self._retired_fds += [old_rfd, old_wfd]
        self._files = new_files
        self._end = at
        self.dead_bytes = 0
        self._gen += 1
        self.n_compactions += 1
        self.compacted_reclaimed_bytes += old_end - at

    def close(self) -> None:
        with self._lock:
            self._files.clear()
            self.resident_bytes = 0
            self.dead_bytes = 0
            for fd in (self._wfd, self._rfd, *self._retired_fds):
                if fd is not None:
                    os.close(fd)
            self._wfd = self._rfd = None
            self._retired_fds = []
            self._end = 0
            d, self._dir = self._dir, None
        if d is not None and self._owns_dir:
            shutil.rmtree(d, ignore_errors=True)


class TieredStore(HostStore):
    """Capacity-bounded host tier backed by a disk tier.

    The host arena keeps :class:`HostStore` semantics (and counters); on
    top of it:

    * :meth:`spill` moves a key's bytes host→disk (a no-op write when an
      immutable disk copy already exists — the disk analogue of
      ``reuse_host_copy``), or drops them entirely for dead data;
    * :meth:`load` stages a disk copy back into host RAM (the first hop of
      a ``disk→host→device`` reload chain);
    * :meth:`get_offload` reads through: if only the disk copy exists, it
      is loaded (and its I/O counted) transparently — a racy or
      plan-driven order can therefore never change results, only timing;
    * with ``auto_spill=True`` (standalone use), :meth:`put_offload`
      evicts least-recently-touched keys once ``host_capacity`` would be
      exceeded — the runtime-LRU complement of the compiler's
      Belady-over-the-schedule victim choice.

    Eviction refusal: when the backing :class:`DiskStore` has a
    ``capacity`` and is full, a spill (auto-LRU or plan-driven) surfaces
    the tier's :class:`DiskFullError` to the caller with the hierarchy
    rolled back to its prior state — the victim keeps its host copy, a
    refused :meth:`put_offload` admission is undone — so the tiers never
    silently exceed either budget and no data is ever lost to a refusal.
    """

    def __init__(self, inputs: dict[int, Any], *,
                 device: str | torch.device | None = None,
                 host_capacity: int | None = None,
                 disk: DiskStore | None = None,
                 directory: str | os.PathLike | None = None,
                 disk_capacity: int | None = None,
                 auto_spill: bool = True,
                 lease: Any = None) -> None:
        super().__init__(inputs, device=device)
        self.host_capacity = host_capacity
        self.disk = (disk if disk is not None
                     else DiskStore(directory, capacity=disk_capacity))
        self._owns_disk = disk is None
        self.auto_spill = auto_spill
        # a pool Lease (repro_torch.core.pool): occupancy deltas are mirrored
        # into it, and — for auto-LRU stores — the *dynamic* grant is the
        # effective host bound, so an arbiter revoking slack makes the
        # next admission spill down without any inline write on the
        # revoker's thread
        self.lease = lease
        # liveness assumption A1's disk face (DESIGN.md §14): when the
        # owning runtime stamped the plan liveness-certified, every spill
        # was statically proven creditable, so a DiskFullError here means
        # the certifier is unsound — escalate instead of refusing
        self.certified_live = False
        self._lru: dict[Any, int] = {}       # key -> last-touch counter
        self._tick = 0

    # ------------------------------------------------------------- hooks
    def _touch(self, key) -> None:
        self._tick += 1
        self._lru[key] = self._tick

    def _host_limit(self) -> int | None:
        """The effective host bound: the lease's arbitrated grant when the
        store belongs to a pool, else the static ``host_capacity``."""
        if self.lease is not None:
            return self.lease.grant
        return self.host_capacity

    def _account_locked(self, delta: int) -> None:
        if self.lease is not None:
            self.lease.account(delta)

    def _admit_locked(self, key, *, fresh: bool = True) -> None:
        self._touch(key)
        if self.auto_spill and self._host_limit() is not None:
            try:
                # the limit is re-read per victim: under a lease it is the
                # *dynamic* arbitrated grant, and each spill's accounting
                # can move it (a demand arbiter re-splits as our occupancy
                # drops)
                while (self.resident_bytes > (self._host_limit() or 0)
                       and len(self.offloaded) > 1):
                    victim = min((k for k in self.offloaded if k != key),
                                 key=lambda k: self._lru.get(k, 0),
                                 default=None)
                    if victim is None:
                        break
                    self._spill_locked(victim)
            except DiskFullError:
                # the cascaded spill could not make room: refuse the
                # admission itself, or the host tier would exceed the
                # bound by one refused value per retry. The victim's bytes
                # were already restored by _spill_locked; dropping the
                # admitted key returns the hierarchy to its pre-put state
                # before the error surfaces — including the key's old disk
                # twin, which is only superseded below once the admission
                # stands (a refusal must never lose the last copy).
                val = self.offloaded.pop(key, None)
                if val is not None:
                    self.resident_bytes -= _nbytes(val)
                    self._account_locked(-_nbytes(val))
                self._lru.pop(key, None)
                if fresh:
                    raise
                # staged admission (disk→host load): the disk copy is
                # still authoritative, so nothing is lost — the read is
                # served without admitting the bytes, and no error
                # surfaces for a read that used to succeed
                return
        if fresh:
            # the admitted write supersedes any disk twin: the blob holds
            # the *old* bytes, and leaving it would make a later spill
            # dedup ("immutable disk copy already exists") resurrect them
            # on read-through — silent data corruption
            self.disk.drop(key)

    # ------------------------------------------------------------- tiers
    def _spill_locked(self, key, *, drop: bool = False) -> int:
        val = self.offloaded.pop(key, None)
        if val is not None:
            self.resident_bytes -= _nbytes(val)
            self._account_locked(-_nbytes(val))
        self._lru.pop(key, None)
        if drop:
            self.disk.drop(key)
            return 0
        if val is not None and key not in self.disk:
            try:
                return self.disk.put(key, val)
            except DiskFullError:
                # refusal must not lose data: the bytes' only copy goes
                # back where it was, and the typed error surfaces to the
                # caller with the hierarchy unchanged
                self.offloaded[key] = val
                self.resident_bytes += _nbytes(val)
                self._account_locked(_nbytes(val))
                self._touch(key)
                raise
        return 0

    def spill(self, key, *, drop: bool = False) -> int:
        """Evict ``key``'s bytes from the host arena; returns the bytes
        actually written to disk. ``drop=True`` means the data is dead:
        release every copy without any disk write. When an immutable disk
        copy already exists the host bytes are simply released (no second
        write, 0 returned). No-op (0) when the key is not host-resident."""
        try:
            with self._lock:
                return self._spill_locked(key, drop=drop)
        except DiskFullError as e:
            if self.certified_live:
                from .liveness import LivenessModelError
                raise LivenessModelError(
                    f"{e} [plan was liveness-certified: every disk "
                    f"admission was proven creditable in all orders, so "
                    f"this refusal means the certifier is unsound or the "
                    f"runtime diverged from the plan — DESIGN.md §14]"
                ) from e
            raise

    def load(self, key):
        """Stage ``key``'s disk copy back into host RAM (disk-read traffic
        counted; the disk copy stays valid). Idempotent when the bytes are
        already host-resident.

        Staging is an *admission*: it runs through the same eviction path
        as :meth:`put_offload` (``fresh=False`` — the disk twin stays
        authoritative), so a burst of read-throughs under ``auto_spill``
        evicts LRU victims instead of silently pushing ``resident_bytes``
        past the host bound. If eviction cannot make room (disk full),
        the bytes are served without being admitted — the read succeeds
        and the budget holds."""
        with self._lock:
            if key in self.offloaded:
                self._touch(key)
                return self.offloaded[key]
        val = self.disk.get(key)
        if self.pinned:   # staged bytes feed an h2d copy: page-lock them
            val = ({k: v.pin_memory() for k, v in val.items()}
                   if isinstance(val, dict) else val.pin_memory())
        with self._lock:
            if key not in self.offloaded:
                self.offloaded[key] = val
                self.resident_bytes += _nbytes(val)
                self.peak_resident_bytes = max(self.peak_resident_bytes,
                                               self.resident_bytes)
                self._account_locked(_nbytes(val))
                self._admit_locked(key, fresh=False)
            else:
                self._touch(key)
            return self.offloaded.get(key, val)

    # --------------------------------------------------- HostStore surface
    def get_offload(self, key):
        with self._lock:
            val = self.offloaded.get(key)
            if val is not None:
                self.reload_bytes += _nbytes(val)
                self._touch(key)
                return val
        # read-through: two-hop reload (disk→host staging, then h2d)
        val = self.load(key)
        with self._lock:
            self.reload_bytes += _nbytes(val)
        return val

    def pop_offload(self, key) -> None:
        super().pop_offload(key)
        with self._lock:
            self._lru.pop(key, None)
        self.disk.drop(key)

    def peek_offload(self, key):
        with self._lock:
            if key in self.offloaded:
                return self.offloaded[key]
        if key in self.disk:
            try:
                return self.disk.get(key, count=False)
            except KeyError:        # dropped between the check and the read
                return None
        return None

    def tier_of(self, key) -> str | None:
        with self._lock:
            if key in self.offloaded:
                return "host"
        return "disk" if key in self.disk else None

    def lru_keys(self) -> list:
        """Host-resident keys, least-recently-touched first — the serving
        engine's spill-candidate order."""
        with self._lock:
            return sorted(self.offloaded, key=lambda k: self._lru.get(k, 0))

    def close(self) -> None:
        if self.lease is not None:
            # the arena is being released: give the pool its bytes back
            # even if values are still readable by a holder of the store
            with self._lock:
                self._account_locked(-self.resident_bytes)
                self.lease = None
        if self._owns_disk:
            self.disk.close()
