"""Write-ahead log: append-only tagged entries with crc32 framing and mmap reads.

The port's copy of ``mysticeti_tpu.wal``.

Capability parity with ``mysticeti-core/src/wal.rs``:

* ``walf(path) -> (WalWriter, WalReader)``                      (wal.rs:38-41)
* 16-byte entry header (magic, crc32, len, tag)                  (wal.rs:110-112,211-223)
* positional addressing: a ``WalPosition`` is the byte offset of the entry header,
  ``POSITION_MAX`` is the reserved "none" position                (wal.rs:31-36)
* reads return memory-mapped views                               (wal.rs:226-259)
* ``iter_until`` replay iterator used for crash recovery         (wal.rs:270-293)
* ``WalSyncer`` — handle for lock-free fsync from a separate thread (wal.rs:199-208)
* ``MAX_ENTRY_SIZE`` bound                                       (wal.rs:107)

Design notes (new implementation, not a port): the reference manages 16 MiB
map-aligned windows and pads entries so they never straddle a window
(wal.rs:96-104).  Here the reader maps the whole file and remaps lazily as it
grows, which gives the same zero-copy property without padding logic; the writer
issues unbuffered ``os.write`` so entries become visible to the reader (via page
cache) immediately, and ``sync`` / ``WalSyncer.sync`` force durability.  A torn
tail entry (crash mid-write) fails its crc and cleanly terminates replay.
"""
from __future__ import annotations

import mmap
import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

from .native import native as _native


def _close_quietly(m: mmap.mmap) -> None:
    """Close a mapping, tolerating a transient buffer export (the native
    wal_scan holds the buffer only for the duration of the call); the mapping
    is then released when the last reference drops instead."""
    try:
        m.close()
    except BufferError:
        pass

Tag = int
WalPosition = int

_HEADER = struct.Struct("<IIII")  # magic, crc32(payload), payload len, tag
HEADER_SIZE = _HEADER.size
WAL_MAGIC = 0x314C4157  # b"WAL1" little-endian
POSITION_MAX: WalPosition = (1 << 64) - 1
MAX_ENTRY_SIZE = 64 * 1024 * 1024  # bound on a single entry payload


class WalError(IOError):
    """Corrupt or inconsistent WAL content."""


def walf(
    path: str, async_writes: Optional[bool] = None
) -> Tuple["WalWriter", "WalReader"]:
    """Open (creating if needed) the log at ``path`` (wal.rs:38-50).

    ``async_writes=False`` forces synchronous appends (no drain thread) —
    the deterministic simulators need it because a real thread's progress
    is wall-clock state, and anything observing it (``pending()`` feeds
    the ingress admission controller's ``wal_backlog`` signal) would leak
    nondeterminism into a seeded virtual-time run."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    size = os.fstat(fd).st_size
    writer = WalWriter(fd, size, path, async_writes=async_writes)
    reader = WalReader(path)
    reader._inflight = writer.inflight_get
    reader._writer_flush = writer.flush
    return writer, reader


class WalWriter:
    """Single-owner appender.  Not thread-safe by design: all appends come
    from the consensus owner task (the reference's single core thread,
    core_thread/spawned.rs).

    Appends are ASYNCHRONOUS by default: ``writev`` frames the entry,
    assigns its position, parks the framed bytes in an in-flight map, and
    hands the actual ``pwrite`` to a dedicated writer thread — a ~5 MB
    block entry costs the event loop microseconds instead of a ~37 ms
    blocking write (measured 15% of wall time at saturated load).  Readers
    see in-flight entries through :meth:`inflight_get` (``walf`` wires the
    paired :class:`WalReader` to it), so read-after-write holds even before
    the bytes reach the page cache.

    Durability: WEAKER than synchronous appends for queued entries — until
    the drain thread's pwrite lands, an acknowledged entry lives only in
    process memory, so a plain process crash (OOM/SIGKILL) can lose it; the
    reference's synchronous writev put entries in the page cache, where only
    OS/power failure could.  Callers whose entries become EXTERNALLY VISIBLE
    (an own proposal handed to dissemination) must ``flush()`` first —
    ``Core.try_new_block`` does — restoring the page-cache floor exactly
    where equivocation is at stake.  ``sync`` drains the queue then fsyncs,
    the 1 s syncer thread bounds the fsync loss window, and a crash
    truncates to a torn tail exactly as before (the queue preserves append
    order; the drain thread writes sequentially).
    ``MYSTICETI_SYNC_WAL_WRITES=1`` restores fully synchronous appends.
    A/B at 24k offered tx/s on a single-core host: identical throughput,
    27% lower average commit latency with the writer thread (221 ms vs
    304 ms) — write stalls leave the consensus critical path even when the
    core itself stays busy.
    """

    __slots__ = ("_fd", "_pos", "_path", "_closed", "_async", "_queue",
                 "_inflight", "_inflight_lock", "_thread", "_error")

    def __init__(self, fd: int, pos: int, path: str,
                 async_writes: Optional[bool] = None) -> None:
        self._fd = fd
        self._pos = pos
        self._path = path
        self._closed = False
        os.lseek(fd, 0, os.SEEK_END)  # append after any recovered content
        if async_writes is None:
            async_writes = os.environ.get("MYSTICETI_SYNC_WAL_WRITES") != "1"
        self._async = async_writes
        self._error: Optional[BaseException] = None
        if async_writes:
            import queue as _queue

            self._queue: "_queue.SimpleQueue" = _queue.SimpleQueue()
            self._inflight: dict = {}
            self._inflight_lock = threading.Lock()
            self._thread = threading.Thread(
                target=self._drain, name="wal-writer", daemon=True
            )
            self._thread.start()
        else:
            self._queue = None
            self._inflight = {}
            self._inflight_lock = threading.Lock()
            self._thread = None

    def write(self, tag: Tag, payload: bytes) -> WalPosition:
        return self.writev(tag, (payload,))

    def _frame(self, tag: Tag, parts: Sequence[bytes]) -> Tuple[bytes, int]:
        length = sum(len(p) for p in parts)
        if length > MAX_ENTRY_SIZE:
            raise WalError(f"entry of {length} bytes exceeds MAX_ENTRY_SIZE")
        if _native is not None:
            # Single-pass native framing (header + parts + crc in one buffer).
            frame = _native.frame_entry(tag, list(parts))
        else:
            crc = 0
            for p in parts:
                crc = zlib.crc32(p, crc)
            frame = _HEADER.pack(WAL_MAGIC, crc, length, tag) + b"".join(parts)
        return frame, HEADER_SIZE + length

    def writev(self, tag: Tag, parts: Sequence[bytes]) -> WalPosition:
        """Append one entry assembled from ``parts`` (scatter write, wal.rs:150-198)."""
        assert not self._closed
        if self._error is not None:
            # The drain thread failed (ENOSPC, bad fd): positions already
            # handed out may never land — fail stop, loudly.
            raise self._error
        frame, total = self._frame(tag, parts)
        position = self._pos
        if self._async:
            with self._inflight_lock:
                self._inflight[position] = frame
            self._queue.put(position)
            self._pos = position + total
            return position
        self._pwrite_all(frame, position, total)
        self._pos = position + total
        return position

    def _pwrite_all(self, frame: bytes, position: int, total: int) -> None:
        # A short write (ENOSPC, signal) would desynchronize every WAL
        # position recorded downstream — write until complete or fail loudly
        # (the reference asserts written == expected, wal.rs:185).
        buf = memoryview(frame)
        written = 0
        while written < total:
            n = os.pwrite(self._fd, buf[written:], position + written)
            if n <= 0:
                raise WalError(
                    f"short WAL write: {written}/{total} bytes at {position}"
                )
            written += n

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, threading.Event):
                item.set()  # flush marker: everything before it has landed
                continue
            with self._inflight_lock:
                frame = self._inflight.get(item)
            if frame is None:
                continue
            try:
                self._pwrite_all(frame, item, len(frame))
            except BaseException as exc:  # noqa: BLE001 - recorded, re-raised
                self._error = exc
                return
            with self._inflight_lock:
                self._inflight.pop(item, None)

    def inflight_get(self, position: WalPosition) -> Optional[bytes]:
        """Framed bytes of a queued-but-unwritten entry (reader seam).

        Once the drain thread has failed, parked entries will NEVER reach
        disk — serving them as successful reads would hand out data that
        does not exist durably.  Fail-stop propagates to readers too."""
        if self._error is not None:
            raise self._error
        with self._inflight_lock:
            return self._inflight.get(position)

    def pending(self) -> bool:
        """True while acknowledged appends are still queued in process
        memory (cheap gate: callers skip the flush marker round-trip when
        the drain thread is already caught up — the common case)."""
        if not self._async:
            return False
        with self._inflight_lock:
            return bool(self._inflight)

    def flush(self) -> None:
        """Block until every queued append has reached the file."""
        # Drain-thread liveness is real-mode-only state: sim WALs are
        # synchronous (walf() forces async_writes=False), so ``_thread`` is
        # None and these probes are constant in virtual time.
        if not self._async or self._thread is None or not self._thread.is_alive():  # lint: ignore[sim-taint]
            if self._error is not None:
                raise self._error
            return
        marker = threading.Event()
        self._queue.put(marker)
        while not marker.wait(timeout=1.0):
            if self._error is not None:
                raise self._error
            if not self._thread.is_alive():  # lint: ignore[sim-taint] (same: real drain thread only)
                break
        if self._error is not None:
            raise self._error

    def truncate_to(self, position: WalPosition) -> None:
        """Discard a torn tail discovered during recovery.

        Replay stops at the first corrupt entry; everything past it was never
        acknowledged.  Appends must resume AT the tear, not after it: a new
        entry written past the torn bytes would be unreachable on the next
        replay (iteration stops at the tear forever), silently losing every
        subsequent acknowledged write.  Recovery calls this before the first
        post-restart append (block_store.py:open)."""
        assert not self._closed
        assert position <= self._pos
        self.flush()  # nothing should be queued at recovery time; be safe
        os.ftruncate(self._fd, position)
        os.lseek(self._fd, 0, os.SEEK_END)
        self._pos = position

    def position(self) -> WalPosition:
        return self._pos

    def size_bytes(self) -> int:
        """Live log bytes.  For the single-file log this IS the append
        position; the segmented WAL (storage.py) overrides it to sum the
        surviving segments so the ``wal_size_bytes`` gauge reflects disk
        actually held, not lifetime bytes written."""
        return self._pos

    def segment_count(self) -> int:
        return 1

    def note_round(self, round_: int, position: Optional[WalPosition] = None) -> None:
        """Lifecycle hook: the segmented writer (storage.py) tracks the max
        block round per segment as its GC predicate; the single-file log has
        no segments to retire, so this is a no-op."""

    def sync(self) -> None:
        self.flush()
        os.fsync(self._fd)

    def syncer(self) -> "WalSyncer":
        """An independently-owned fsync handle usable from another thread
        (wal.rs:199-208).  Carries a flush hook into this writer: with async
        appends, an fsync that does not drain the queue first would not
        cover acknowledged entries and the 1 s loss-window bound would be a
        lie."""
        return WalSyncer(self._path, flush=self.flush)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.flush()
            finally:
                if self._thread is not None and self._thread.is_alive():  # lint: ignore[sim-taint] (same: real drain thread only)
                    self._queue.put(None)
                    self._thread.join(timeout=5.0)
                os.close(self._fd)


class WalSyncer:
    """Fsync handle decoupled from the writer: owns its own descriptor so a
    dedicated flusher thread never contends with the appender (wal.rs:199-208,
    used by net_sync.rs:496-560's AsyncWalSyncer)."""

    __slots__ = ("_fd", "_flush")

    def __init__(self, path: str, flush=None) -> None:
        self._fd = os.open(path, os.O_RDWR)
        self._flush = flush

    def sync(self) -> None:
        if self._flush is not None:
            try:
                self._flush()
            except (WalError, OSError):
                # The writer already records and re-raises its own failure
                # on the append path; the fsync of what DID land still runs.
                pass
        os.fsync(self._fd)

    def close(self) -> None:
        os.close(self._fd)


class WalReader:
    """Random-access reader over the log; thread-safe.

    Reads go through a whole-file mmap that is lazily re-created when the file has
    grown past the mapped size (the reference's analogue: 16 MiB windows mapped on
    demand, wal.rs:96-104,226-259).  ``cleanup`` drops the mapping so the OS can
    reclaim page cache (wal.rs:302-311 equivalent).
    """

    __slots__ = ("_fd", "_map", "_map_size", "_lock", "_path", "_inflight",
                 "_writer_flush")

    def __init__(self, path: str) -> None:
        self._fd = os.open(path, os.O_RDONLY)
        self._path = path
        self._map: Optional[mmap.mmap] = None
        self._map_size = 0
        self._lock = threading.Lock()
        # Read-through for the paired writer's queued-but-unwritten entries
        # (async appends): set by walf().  None for standalone readers.
        self._inflight = None
        self._writer_flush = None

    # -- mapping management --

    def _ensure_mapped(self, end: int) -> Optional[mmap.mmap]:
        """Map at least [0, end); returns None if the file is still shorter than end."""
        with self._lock:
            if self._map is not None and end <= self._map_size:
                return self._map
            size = os.fstat(self._fd).st_size
            if end > size:
                return None
            if self._map is not None:
                _close_quietly(self._map)
            self._map = mmap.mmap(self._fd, size, prot=mmap.PROT_READ)
            self._map_size = size
            return self._map

    def cleanup(self) -> int:
        """Drop the current mapping; returns number of retained maps (0/1)."""
        with self._lock:
            if self._map is not None:
                _close_quietly(self._map)
                self._map = None
                self._map_size = 0
        return 0

    # -- reads --

    def _read_header(self, position: WalPosition) -> Optional[Tuple[int, int, Tag]]:
        m = self._ensure_mapped(position + HEADER_SIZE)
        if m is None:
            return None
        magic, crc, length, tag = _HEADER.unpack_from(m, position)
        if magic != WAL_MAGIC:
            return None
        return crc, length, tag

    def read(self, position: WalPosition) -> Tuple[Tag, bytes]:
        """Read the entry at ``position``; raises WalError on corruption (wal.rs:226-259)."""
        if self._inflight is not None:
            # Entry may still be queued in the writer thread: serve it from
            # the in-flight frame so read-after-write never races the disk.
            frame = self._inflight(position)
            if frame is not None:
                _, _, length, tag = _HEADER.unpack_from(frame, 0)
                return tag, frame[HEADER_SIZE:HEADER_SIZE + length]
        header = self._read_header(position)
        if header is None:
            raise WalError(f"no valid wal entry at position {position}")
        crc, length, tag = header
        m = self._ensure_mapped(position + HEADER_SIZE + length)
        if m is None:
            raise WalError(f"truncated wal entry at position {position}")
        payload = bytes(
            memoryview(m)[position + HEADER_SIZE : position + HEADER_SIZE + length]
        )
        if zlib.crc32(payload) != crc:
            raise WalError(f"crc mismatch at position {position}")
        return tag, payload

    def iter_until(
        self, end: Optional[WalPosition] = None
    ) -> Iterator[Tuple[WalPosition, Tag, bytes]]:
        """Replay all entries from the start up to ``end`` (or the current file end).

        A torn/corrupt tail entry terminates iteration silently — that is the
        crash-recovery contract (wal.rs:270-293): everything before the tear was
        durable, the tear itself was never acknowledged.
        """
        pos: WalPosition = 0
        if self._writer_flush is not None:
            # Replay must see every acknowledged append: drain the paired
            # writer's queue before snapshotting the file end.
            self._writer_flush()
        if end is None:
            end = os.fstat(self._fd).st_size
        if _native is not None and end > 0:
            m = self._ensure_mapped(end)
            if m is None:
                return
            # Collect the offsets first, then slice the mmap directly
            # (mmap slicing copies): no exported buffer lives across a yield,
            # so concurrent remap/cleanup in other threads stays legal.  A
            # cleanup() landing between yields closes the map under us — the
            # slice then raises ValueError and we re-resolve the mapping.
            entries = _native.wal_scan(m, end)
            for pos, tag, off, length in entries:
                try:
                    payload = m[off : off + length]
                except ValueError:
                    m = self._ensure_mapped(end)
                    if m is None:
                        return
                    payload = m[off : off + length]
                yield pos, tag, payload
            return
        while pos + HEADER_SIZE <= end:
            header = self._read_header(pos)
            if header is None:
                return
            crc, length, tag = header
            if pos + HEADER_SIZE + length > end:
                return
            try:
                tag2, payload = self.read(pos)
            except WalError:
                return
            yield pos, tag2, payload
            pos += HEADER_SIZE + length

    def iter_from(
        self, start: WalPosition, end: Optional[WalPosition] = None
    ) -> Iterator[Tuple[WalPosition, Tag, bytes]]:
        """Replay entries from ``start`` (an entry boundary) up to ``end``.

        Checkpoint recovery (storage.py) resumes replay at the position the
        checkpoint recorded instead of byte zero.  Same torn-tail contract as
        :meth:`iter_until`; a ``start`` that is not a valid entry boundary
        yields nothing (the caller's replayed-end accounting then treats
        everything past it as torn).
        """
        if start == 0:
            yield from self.iter_until(end)
            return
        if self._writer_flush is not None:
            self._writer_flush()
        if end is None:
            end = os.fstat(self._fd).st_size
        pos: WalPosition = start
        while pos + HEADER_SIZE <= end:
            header = self._read_header(pos)
            if header is None:
                return
            _crc, length, tag = header
            if pos + HEADER_SIZE + length > end:
                return
            try:
                tag2, payload = self.read(pos)
            except WalError:
                return
            yield pos, tag2, payload
            pos += HEADER_SIZE + length

    def close(self) -> None:
        self.cleanup()
        os.close(self._fd)
