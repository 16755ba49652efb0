# lint: ignore-module[sim-taint] — standalone socket-server process: runs
# outside any validator's event loop (real or simulated); its calibration
# clocks can never leak into a seeded sim's timeline.
"""Shared per-host verifier service: ONE warmed card runtime for the fleet.

The port's copy of ``mysticeti_tpu.verifier_service``.  Giving every
validator process on a host its own accelerator runtime makes N processes
pay the runtime's start, the kernels' load and the key combs' upload each,
and opens N contexts on the one card.  Here the accelerator runtime is a
HOST resource, owned by one process and shared by every co-located
validator:

  * :class:`VerifierServer` — owns a single :class:`TorchSignatureVerifier`
    (one CUDA context, the kernels built and loaded once, the committee's
    key combs on the card), serves signature batches over a unix-domain
    socket.  Requests from different validators dispatch concurrently.
  * :class:`RemoteSignatureVerifier` — the validator-side
    :class:`SignatureVerifier` that forwards batches to the service.  It
    never touches the card: a validator process using it boots light, and a
    REBOOTED validator re-attaches to the still-warm service.

Wire protocol (little-endian, length-prefixed frames), byte for byte the
JAX package's, so either package's client talks to either server:

  frame    = u32 payload_len | u8 type | payload
  HELLO    (1)   u16 n_keys | n_keys * 32 B pk      -> HELLO_OK once warm
  VERIFY   (2)   u32 req_id | u32 n | n * (u16 key_idx | 32 B digest | 64 B sig)
  RAW      (3)   u32 req_id | u32 n | n * (32 B pk | 32 B digest | 64 B sig)
  HELLO_OK (128) f64 fixed_dispatch_s | f64 per_sig_s | utf-8 backend
                 (empty = uncalibrated; exactly 16 B = calibrated service
                 that names no backend)
  RESULT   (129) u32 req_id | n * u8 ok
  ERR      (255) utf-8 message (protocol error; connection closes)

The HELLO_OK ``backend`` suffix advertises the service's ACTUAL resolved
platform: the backend's ``resolved_backend()``, "cuda" when the kernels run
on a card, "cpu" for a host oracle or ``device="cpu"``.  The hybrid router
pins routing to its in-process oracle when the advertised backend is
CPU-only, so the socket hop disappears exactly when there is nothing behind
it to pay for.  An old client sees a >16-byte HELLO_OK, fails its
``len == 16`` calibration check and falls back to its own probe; a new
client against an old service sees exactly 16 bytes and leaves the backend
unknown (no pinning).

HELLO doubles as the warmup gate: the reply is sent only after the
backend's one-time warmup (kernel build and load, comb uploads) finished.
All clients must present the same committee (one table per service); a
mismatch is an ERR.  HELLO_OK carries the service's OWN dispatch calibration
(a timed 1-signature and 256-signature dispatch after warmup), so N
validators never serialize N probe dispatches behind a booting fleet.

One difference from the JAX package: ``_verify_payload`` hands the backend
``bytes``, not ``memoryview`` slices of the frame.  The ``cryptography``
oracle's ``Ed25519PublicKey.from_public_bytes`` refuses a memoryview, so the
JAX package's service fails every RAW request on its CPU backend.
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import os
import random
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

from .block_validator import (
    CpuSignatureVerifier,
    SignatureVerifier,
    VerifierProtocolError,
)
from .network import jittered_backoff
from .tracing import logger
from .utils.tasks import spawn_logged
from .verify_pipeline import CompletedDispatch, DeferredDispatch

log = logger(__name__)

T_HELLO = 1
T_VERIFY = 2
T_RAW = 3
T_HELLO_OK = 128
T_RESULT = 129
T_ERR = 255

_IDX_REC = 2 + 32 + 64  # u16 idx | digest | sig
_RAW_REC = 32 + 32 + 64

ENV_SOCKET = "MYSTICETI_VERIFIER_SOCKET"

# VerifierProtocolError (re-exported above from block_validator): the service
# answered but REJECTED the request.  Excluded from the client's retry loop
# AND from the hybrid circuit breaker — a misconfigured validator fails fast
# instead of hammering the service or silently degrading to the oracle.


def _frame(type_: int, payload: bytes) -> bytes:
    """Frames the small messages (HELLO, HELLO_OK, ERR).  The hot paths — VERIFY
    requests client-side, RESULT replies service-side — do NOT come through
    here: they pack into reusable buffers / scatter-gather parts so payload
    bytes are copied at most once per direction."""
    return struct.pack("<IB", len(payload), type_) + payload


class _WireBuffer:
    """Reusable pack/recv scratch buffer: grown geometrically, never shrunk
    or reallocated per dispatch.  One per (thread, direction) on the client:
    the executor threads own their connections thread-locally, so per-thread
    IS per-connection."""

    __slots__ = ("buf", "grows")

    def __init__(self, size: int = 4096) -> None:
        self.buf = bytearray(size)
        self.grows = 0

    def reserve(self, n: int) -> bytearray:
        if len(self.buf) < n:
            size = len(self.buf)
            while size < n:
                size *= 2
            self.buf = bytearray(size)
            self.grows += 1
        return self.buf


def _peer_uid(sock) -> Optional[int]:
    """UID of the unix-socket peer via SO_PEERCRED, or None when the
    platform cannot say (non-Linux): directory permissions remain the
    defense there.  Module-level so tests can stub a foreign peer."""
    if sock is None:
        return None
    try:
        creds = sock.getsockopt(
            socket.SOL_SOCKET, socket.SO_PEERCRED, struct.calcsize("3i")
        )
        _pid, uid, _gid = struct.unpack("3i", creds)
        return uid
    except (AttributeError, OSError, struct.error):
        return None


def _abandoned_reply(fut: asyncio.Future, cleanup) -> None:
    """Completion hook for a dispatch whose connection died before its reply
    could be written: retrieve the exception (so asyncio never logs it as
    never-retrieved at GC) and only then release the service gauges."""
    if not fut.cancelled() and fut.exception() is not None:
        log.error(
            "verifier service dispatch failed after client disconnect",
            exc_info=fut.exception(),
        )
    if cleanup is not None:
        cleanup()


# ---------------------------------------------------------------------------
# Server


class VerifierServer:
    """One card runtime serving every validator on the host.

    ``backend`` overrides the default, a ``TorchSignatureVerifier`` over the
    committee's keys on ``device`` (``cuda`` unless given; without a card
    its construction raises at the first HELLO or ``prewarm``)."""

    # Per-connection staged request window: the reader decodes request N+1
    # while N computes in the pool; replies are written strictly in request
    # order by a dedicated writer task.  The bound backpressures a client
    # pipelining faster than the backend drains.
    PIPELINE_DEPTH = 8

    def __init__(self, socket_path: str, committee_keys: Optional[Sequence[bytes]] = None,
                 backend=None, metrics=None, device=None) -> None:
        self.socket_path = socket_path
        self._backend = backend
        self._owns_backend = backend is None
        self.device = device
        self._keys: Optional[List[bytes]] = (
            list(committee_keys) if committee_keys else None
        )
        # Optional Metrics: queue depth / per-connection in-flight gauges +
        # dispatch shape series, scrapeable when the service runs with
        # --metrics-port.
        self.metrics = metrics
        self._conn_ids = itertools.count()
        self._warmed = threading.Event()
        self._warm_lock = threading.Lock()
        # Sized for a 10+ validator fleet: each in-flight request blocks a
        # worker thread on the device fetch, and overlapping those
        # round-trips is the entire point of sharing the runtime.
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="verify-dispatch"
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self._calibration: Optional[Tuple[float, float]] = None

    # -- backend lifecycle --

    def _ensure_backend(self, keys: List[bytes]):
        # The whole init+warmup runs under the lock: concurrent HELLOs from a
        # booting fleet must not race two warmups — the losers block here
        # until the first one finishes (exactly what their HELLO wants).
        with self._warm_lock:
            if keys:
                if self._keys is None:
                    # First NON-EMPTY committee establishes the service key
                    # set: an early zero-key HELLO from a RAW-only client
                    # must not pin the committee to [] and poison every
                    # later client with a permanent mismatch.  A keyless
                    # backend already built for such a client is rebuilt
                    # around the real committee's key table.
                    self._keys = keys
                    if self._backend is not None and self._owns_backend:
                        self._backend = None
                        self._warmed.clear()
                elif self._keys != keys:
                    raise ValueError(
                        "committee mismatch: this verifier service was warmed "
                        "for a different key set"
                    )
            if self._backend is None:
                from .block_validator import TorchSignatureVerifier

                self._backend = TorchSignatureVerifier(
                    committee_keys=self._keys, device=self.device
                )
                self._owns_backend = True
            if not self._warmed.is_set():
                self._backend.warmup()
                self._calibrate()
                self._warmed.set()
            return self._backend

    def _calibrate(self) -> None:
        """Time the warmed backend once: a 1-signature dispatch (fixed cost)
        and a 256-signature dispatch (marginal cost), on the deployed
        committee-indexed path.  Shared with every client via HELLO_OK."""
        keys = self._keys or []
        if not keys:
            return
        pk = keys[0]
        digest = bytes(32)
        sig = bytes(64)
        try:
            t0 = time.monotonic()
            self._backend.verify_signatures([pk], [digest], [sig])
            fixed = time.monotonic() - t0
            n = 256
            t0 = time.monotonic()
            self._backend.verify_signatures(
                [keys[i % len(keys)] for i in range(n)],
                [digest] * n, [sig] * n,
            )
            batch_t = time.monotonic() - t0
            self._calibration = (fixed, max(0.0, (batch_t - fixed) / n))
            log.info(
                "verifier service calibrated: %.1f ms fixed + %.1f µs/sig",
                1e3 * self._calibration[0], 1e6 * self._calibration[1],
            )
        except Exception:  # calibration is advisory, never fatal
            log.exception("verifier service calibration failed")

    def prewarm(self) -> None:
        """Warm before the first client connects (committee known at boot)."""
        if self._keys is None:
            raise ValueError("prewarm requires committee keys")
        self._ensure_backend(self._keys)

    # -- connection handling --

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # Trust gate first: the socket lives in a 0700 dir, but an unrelated
        # local user who still reached it must not get to submit RAW batches
        # to the warmed backend.  Same-uid and root peers only.
        uid = _peer_uid(writer.get_extra_info("socket"))
        if uid is not None and uid not in (os.getuid(), 0):
            log.warning(
                "verifier service refusing foreign-uid peer (uid %d)", uid
            )
            writer.close()
            return
        # Staged per-connection request pipeline: the reader decodes and
        # submits request N+1 while request N computes in the pool; a
        # dedicated writer task emits replies strictly in request order.
        loop = asyncio.get_running_loop()
        self._writers.add(writer)
        conn_label = f"c{next(self._conn_ids)}"
        replies: asyncio.Queue = asyncio.Queue(maxsize=self.PIPELINE_DEPTH)
        reply_task = spawn_logged(
            self._reply_writer(replies, writer), log, name="verifier-replies"
        )

        def _accounted():
            metrics = self.metrics
            if metrics is None:
                return None
            # Depth = requests handed to the pool and not yet answered;
            # inflight splits it per client connection so one flooding
            # validator is attributable.  Decremented by the writer once the
            # reply is built (cleanup runs even when the dispatch raised).
            metrics.verifier_service_queue_depth.inc()
            metrics.verifier_service_inflight.labels(conn_label).inc()

            def _done():
                metrics.verifier_service_queue_depth.dec()
                metrics.verifier_service_inflight.labels(conn_label).dec()

            return _done

        # A pipelined client may send VERIFY frames behind a HELLO without
        # waiting for HELLO_OK; pool threads run jobs in any order, so a
        # verify must not EXECUTE before the HELLO that establishes the
        # committee finished.  Replies stay ordered by the queue; execution
        # is gated on the connection's last unresolved HELLO only.
        last_hello: Optional[asyncio.Future] = None

        async def _after_hello(gate, type_, req_id, n, body):
            try:
                hello_frame = await asyncio.shield(gate)
            except Exception:  # noqa: BLE001 - HELLO's own reply carries it
                hello_frame = None
            if hello_frame is None or hello_frame[4] == T_ERR:
                # The HELLO was rejected or crashed: the connection is being
                # severed and this reply would be discarded — do NOT burn a
                # backend dispatch for it.
                return None
            return await loop.run_in_executor(
                self._pool, self._result_reply, type_, req_id, n, body
            )

        try:
            while True:
                try:
                    header = await reader.readexactly(5)
                except asyncio.IncompleteReadError:
                    return
                if reply_task.done():
                    return  # writer died (client gone, backend crash)
                length, type_ = struct.unpack("<IB", header)
                payload = await reader.readexactly(length) if length else b""
                if type_ == T_HELLO:
                    n_keys = (
                        struct.unpack_from("<H", payload)[0]
                        if length >= 2 else -1
                    )
                    if n_keys < 0 or length != 2 + 32 * n_keys:
                        await replies.put(
                            (_frame(T_ERR, b"malformed hello frame"),
                             None, True)
                        )
                        return
                    keys = [
                        bytes(payload[2 + 32 * i: 2 + 32 * (i + 1)])
                        for i in range(n_keys)
                    ]
                    # HELLO replies ride the same in-order queue as results:
                    # a client that pipelines frames must never see HELLO_OK
                    # overtake an earlier RESULT.
                    fut = loop.run_in_executor(
                        self._pool, self._hello_reply, keys
                    )
                    last_hello = fut
                    await replies.put((fut, None, False))
                elif type_ in (T_VERIFY, T_RAW):
                    if length < 8:
                        await replies.put(
                            (_frame(T_ERR, b"malformed verify frame"),
                             None, True)
                        )
                        return
                    req_id, n = struct.unpack_from("<II", payload)
                    # A view of the request body: the records are cut into
                    # bytes once, in _verify_payload.
                    body = memoryview(payload)[8:]
                    rec = _IDX_REC if type_ == T_VERIFY else _RAW_REC
                    if len(body) != n * rec:
                        await replies.put(
                            (_frame(T_ERR, b"malformed verify frame"),
                             None, True)
                        )
                        return
                    if last_hello is not None and last_hello.done():
                        rejected = last_hello.cancelled() or (
                            last_hello.exception() is not None
                            or last_hello.result()[4] == T_ERR
                        )
                        if rejected:
                            # The writer is severing after the HELLO's ERR:
                            # frames pipelined behind it must not burn
                            # backend dispatches.
                            return
                        last_hello = None  # accepted: no more gating needed
                    done = _accounted()
                    if last_hello is not None:
                        # Awaited by the reply writer in order, which
                        # observes its exception.
                        fut = asyncio.ensure_future(
                            _after_hello(last_hello, type_, req_id, n, body)
                        )
                    else:
                        fut = loop.run_in_executor(
                            self._pool, self._result_reply,
                            type_, req_id, n, body,
                        )
                    await replies.put((fut, done, False))
                else:
                    await replies.put(
                        (_frame(T_ERR, b"unknown frame type"), None, True)
                    )
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            return
        finally:
            # Let the writer drain everything already submitted, then stop.
            try:
                replies.put_nowait(None)
            except asyncio.QueueFull:
                reply_task.cancel()
            try:
                await reply_task
            except asyncio.CancelledError:
                reply_task.cancel()
            except Exception:  # noqa: BLE001 - writer logged its own failure
                pass
            # Anything left unqueued-for-write still owes its cleanup, but
            # its dispatch may still be running on a pool thread: defer the
            # gauge release and the exception retrieval to its completion.
            abandoned = []
            while True:
                try:
                    item = replies.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if item is None:
                    continue
                frame, cleanup, _close_after = item
                if asyncio.isfuture(frame):
                    abandoned.append((frame, cleanup))
                elif cleanup is not None:
                    cleanup()

            def _remove_label() -> None:
                # Labels are minted per connection from an unbounded counter;
                # a reconnecting fleet would otherwise grow dead
                # {connection="cN"} series in the registry forever.
                if self.metrics is not None:
                    try:
                        self.metrics.verifier_service_inflight.remove(
                            conn_label
                        )
                    except KeyError:
                        pass  # connection closed before its first verify

            if abandoned:
                # The label must outlive every deferred cleanup: a dec()
                # after remove() would re-mint the dead series at -1.  The
                # LAST abandoned dispatch to complete removes it.
                remaining = {"n": len(abandoned)}

                def _finish(fut, cleanup) -> None:
                    _abandoned_reply(fut, cleanup)
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        _remove_label()

                for fut, cleanup in abandoned:
                    fut.add_done_callback(
                        lambda f, cleanup=cleanup: _finish(f, cleanup)
                    )
            else:
                _remove_label()
            self._writers.discard(writer)
            writer.close()

    async def _reply_writer(self, replies: asyncio.Queue,
                            writer: asyncio.StreamWriter) -> None:
        """Emit queued replies in request order; ``None`` ends the stream.
        Queue items are ``(frame_or_future, cleanup, close_after)``.  A
        dispatch failure or a dead client socket flips to drain mode —
        remaining cleanups still run but nothing is written, and the
        transport is closed so the reader unblocks.

        A reply is either a prebuilt ``bytes`` frame (HELLO_OK, ERR) or a
        ``(type, parts)`` tuple from the verify path: a fresh 5-byte header
        rides ``writer.writelines`` with the parts as-is (scatter-gather).
        The header must be a fresh immutable object per reply: the selector
        transport may hold a zero-copy view of writelines' buffers under
        backpressure."""
        dead = False
        while True:
            item = await replies.get()
            if item is None:
                return
            frame, cleanup, close_after = item
            try:
                if asyncio.isfuture(frame):
                    try:
                        frame = await frame
                    except Exception:  # noqa: BLE001 - logged, conn severed
                        log.exception("verifier service dispatch failed")
                        frame = None
                if dead or frame is None:
                    dead = True
                    writer.close()
                    continue
                if isinstance(frame, tuple):
                    type_, parts = frame
                else:
                    type_, parts = frame[4], None
                if type_ == T_ERR:
                    # Protocol errors sever the connection after the reply.
                    close_after = True
                try:
                    if parts is not None:
                        header = struct.pack(
                            "<IB", sum(len(p) for p in parts), type_
                        )
                        writer.writelines((header, *parts))
                    else:
                        writer.write(frame)
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    dead = True
                    continue
                if close_after:
                    dead = True
                    writer.close()
            finally:
                if cleanup is not None:
                    cleanup()

    def _resolved_backend(self) -> str:
        """The platform the warmed backend ACTUALLY dispatches on —
        advertised to every client via HELLO_OK so their hybrid routers can
        short-circuit a service with no accelerator behind it.  Backends
        without the introspection hook are host oracles: "cpu"."""
        resolve = getattr(self._backend, "resolved_backend", None)
        if resolve is None:
            return "cpu"
        try:
            return str(resolve())
        except Exception:  # advisory, never fatal
            log.exception("backend platform introspection failed")
            return "cpu"

    def _hello_reply(self, keys: List[bytes]) -> bytes:
        """Pool-side HELLO handling: warm (or adopt/upgrade) the backend and
        frame the reply — HELLO_OK with the calibration + resolved-backend
        advertisement, or ERR on a committee mismatch.  The backend suffix
        rides only behind a calibration, and an UNcalibrated reply stays
        empty so it is never mistaken for a 16-byte calibration."""
        try:
            self._ensure_backend(keys)
        except ValueError as exc:
            return _frame(T_ERR, str(exc).encode())
        payload = b""
        if self._calibration is not None:
            payload = struct.pack("<dd", *self._calibration)
            payload += self._resolved_backend().encode("ascii", "replace")
        return _frame(T_HELLO_OK, payload)

    def _result_reply(self, type_: int, req_id: int, n: int, body) -> tuple:
        """Verify and return the reply as ``(T_RESULT, parts)`` for the
        writer's scatter-gather."""
        oks = self._verify_payload(type_, n, body)
        return (T_RESULT, (struct.pack("<I", req_id), bytes(oks)))

    def _verify_payload(self, type_: int, n: int, body) -> List[int]:
        """Cut the request's records into ``bytes`` (keys, digests,
        signatures) and verify them.  ``bytes``, not views of ``body``: the
        backends take them as message and key encodings, and the CPU
        oracle's key parser accepts nothing else."""
        backend = self._ensure_backend(self._keys or [])
        data = bytes(body)
        pks, digests, sigs = [], [], []
        if type_ == T_VERIFY:
            keys = self._keys or []
            for i in range(n):
                off = i * _IDX_REC
                (idx,) = struct.unpack_from("<H", data, off)
                if idx >= len(keys):
                    # An out-of-range index cannot verify; reject that slot
                    # rather than the whole batch.
                    pks.append(bytes(32))
                else:
                    pks.append(keys[idx])
                digests.append(data[off + 2: off + 34])
                sigs.append(data[off + 34: off + 98])
        else:
            for i in range(n):
                off = i * _RAW_REC
                pks.append(data[off: off + 32])
                digests.append(data[off + 32: off + 64])
                sigs.append(data[off + 64: off + 128])
        oks = backend.verify_signatures(pks, digests, sigs)
        if self.metrics is not None:
            # The service owns the device, so it (not the clients) is where
            # dispatch shape and padding waste are measurable.
            self.metrics.verify_dispatch_batch_size.observe(n)
            padder = getattr(backend, "padded_batch", None)
            if padder is not None:
                self.metrics.verify_padding_wasted_total.labels(
                    "service"
                ).inc(max(0, padder(n) - n))
        return [1 if ok else 0 for ok in oks]

    # -- lifecycle --

    @staticmethod
    def _secure_socket_dir(socket_path: str) -> None:
        """Bind-time trust check: the socket's parent directory must be OURS
        — created 0700 when absent, refused outright when another uid owns
        it (a foreign owner can rename/replace the socket under us), and
        stripped of group/other bits when we own a looser one.  SO_PEERCRED
        at accept covers the remaining window."""
        parent = os.path.dirname(os.path.abspath(socket_path)) or "."
        if not os.path.isdir(parent):
            os.makedirs(parent, mode=0o700, exist_ok=True)
        st = os.stat(parent)
        if st.st_uid != os.getuid():
            raise PermissionError(
                f"verifier socket dir {parent!r} is owned by uid {st.st_uid}"
                f" (we are {os.getuid()}): refusing to bind into a directory"
                " another user controls"
            )
        if st.st_mode & 0o077:
            os.chmod(parent, 0o700)

    async def start(self) -> None:
        self._secure_socket_dir(self.socket_path)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = await asyncio.start_unix_server(
            self._handle, path=self.socket_path
        )
        # Same-uid-or-root only, and the peercred gate enforces it even
        # where a path somehow stays reachable.
        os.chmod(self.socket_path, 0o600)
        log.info("verifier service listening on %s", self.socket_path)

    async def serve_forever(self) -> None:
        await self.start()
        if self._keys is not None and not self._warmed.is_set():
            # Warm while validators boot: their HELLOs block until done.
            await asyncio.get_running_loop().run_in_executor(
                self._pool, self.prewarm
            )
            log.info("verifier service warmed (%d committee keys)",
                     len(self._keys))
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Sever live client connections first: ``wait_closed`` waits for
            # every connection HANDLER to finish, and handlers block in
            # readexactly on idle-but-open clients.
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=False)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


# ---------------------------------------------------------------------------
# Client


class RemoteSignatureVerifier(SignatureVerifier):
    """Validator-side stub: forwards batches to the host's verifier service.

    Never touches the card: the validator process stays light and leans on
    the service's single warmed runtime.  Called from the batching
    collector's executor threads: each thread keeps its own connection
    (``threading.local``) so concurrent flushes pipeline through the service
    rather than serializing on one socket.
    """

    backend_label = "cuda-remote"

    # Reconnect-retry budget per request: a service restart mid-burst is
    # routine, a fleet boot race is routine — neither is an outage.  Only
    # exhausting the budget propagates, and the hybrid circuit breaker takes
    # it from there.
    MAX_ATTEMPTS = 4
    RETRY_BASE_BACKOFF_S = 0.05
    RETRY_MAX_BACKOFF_S = 1.0

    # Bound on idle pooled connections for the async dispatch path; matches
    # the deepest pipeline window the collector runs (verify_pipeline.py).
    MAX_POOLED_CONNS = 4

    def __init__(self, socket_path: Optional[str] = None,
                 committee_keys: Optional[Sequence[bytes]] = None,
                 timeout_s: float = 300.0,
                 metrics=None,
                 max_attempts: Optional[int] = None) -> None:
        self.socket_path = socket_path or os.environ[ENV_SOCKET]
        self._keys = list(committee_keys or [])
        self._index = {pk: i for i, pk in enumerate(self._keys)}
        self.timeout_s = timeout_s
        self.metrics = metrics
        self.max_attempts = max_attempts or self.MAX_ATTEMPTS
        self._retry_rng = random.Random(0x5E7C1E27)
        self._tls = threading.local()
        # Connection pool for the STAGED path (verify_signatures_async): the
        # submit and the fetch may run on different executor threads, so the
        # in-flight handle carries its connection.  _pool_size counts live
        # pooled conns (idle + checked out) so the pool stays bounded.
        self._pool_conns: List[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._pool_size = 0
        self._async_req_ids = itertools.count(1)
        # (fixed_dispatch_s, per_sig_s) as measured by the SERVICE on its
        # own warmed backend (HELLO_OK payload); None until first connect.
        self.calibration: Optional[Tuple[float, float]] = None
        # The service's resolved platform from the HELLO_OK backend suffix
        # ("cpu" | "cuda" | ...); None against a service that names none or
        # before the first connect.  The hybrid router reads this to pin
        # routing to its in-process oracle when there is no accelerator
        # behind the socket.
        self.advertised_backend: Optional[str] = None

    # -- socket plumbing --

    def _connect(self) -> socket.socket:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(self.timeout_s)
        conn.connect(self.socket_path)
        payload = struct.pack("<H", len(self._keys)) + b"".join(self._keys)
        frame = _frame(T_HELLO, payload)
        conn.sendall(frame)
        self._count_wire("sent", len(frame))
        type_, reply = self._read_frame(conn)
        if type_ != T_HELLO_OK:
            conn.close()
            raise VerifierProtocolError(
                "verifier service rejected hello: "
                f"{bytes(reply).decode(errors='replace')}"
            )
        if len(reply) >= 16:
            self.calibration = struct.unpack_from("<dd", reply)
        # No suffix = backend UNKNOWN — overwrite, don't keep: a stale "cpu"
        # from a replaced service would otherwise hold the hybrid pinned.
        self.advertised_backend = (
            bytes(reply[16:]).decode("ascii", errors="replace")
            if len(reply) > 16
            else None
        )
        return conn

    def dispatch_calibration(self) -> Optional[Tuple[float, float]]:
        """Server-measured (fixed_s, per_sig_s) — the hybrid router's cost
        model, without every client paying its own probe dispatch."""
        return self.calibration

    def rehello(self) -> Tuple[Optional[str], Optional[Tuple[float, float]]]:
        """Fresh HELLO round-trip on this thread's connection; returns the
        service's CURRENT (advertised_backend, calibration).

        The backend-pinned hybrid router's low-frequency upgrade probe: one
        HELLO frame over the wire, never a batch — a service that gained an
        accelerator re-opens offload without a validator restart.  Transport
        failures propagate for the caller's backoff."""
        stale = getattr(self._tls, "conn", None)
        self._tls.conn = None
        if stale is not None:
            try:
                stale.close()
            except OSError:
                pass
        self._conn()
        return self.advertised_backend, self.calibration

    def _conn(self) -> socket.socket:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = self._connect()
            self._tls.conn = conn
            self._tls.req_id = 0
        return conn

    def _count_wire(self, direction: str, nbytes: int) -> None:
        if self.metrics is not None:
            self.metrics.verify_wire_bytes_total.labels(direction).inc(nbytes)

    def _wire(self, attr: str) -> _WireBuffer:
        """Per-thread reusable buffer, one per direction: ``pack`` must stay
        intact across the retry loop's reconnects (which read HELLO_OK into
        ``recv``)."""
        wire = getattr(self._tls, attr, None)
        if wire is None:
            wire = _WireBuffer()
            setattr(self._tls, attr, wire)
        return wire

    @staticmethod
    def _recv_exact(conn: socket.socket, view: memoryview) -> None:
        got, n = 0, len(view)
        while got < n:
            r = conn.recv_into(view[got:])
            if r == 0:
                raise ConnectionError("verifier service closed the connection")
            got += r

    def _read_frame(self, conn: socket.socket):
        """Read one frame into the per-thread recv buffer (``recv_into``)
        and return its payload as a memoryview.  The view aliases the
        reusable buffer — callers consume it before this thread's next read."""
        wire = self._wire("recv")
        head = memoryview(wire.reserve(5))[:5]
        self._recv_exact(conn, head)
        length, type_ = struct.unpack_from("<IB", head)
        payload = memoryview(wire.reserve(length))[:length]
        if length:
            self._recv_exact(conn, payload)
        self._count_wire("recv", 5 + length)
        return type_, payload

    def _roundtrip(self, frame, req_id: int):
        """Send one request with bounded reconnect-retries (jittered
        exponential backoff); each torn-down connection counts on
        ``verifier_reconnect_total``.  Protocol rejections
        (:class:`VerifierProtocolError`) are never retried, and exhausting
        the budget propagates — the hybrid circuit breaker takes it from
        there."""
        backoff = self.RETRY_BASE_BACKOFF_S
        for attempt in range(self.max_attempts):
            try:
                conn = self._conn()
                conn.sendall(frame)
                self._count_wire("sent", len(frame))
                type_, payload = self._read_frame(conn)
                break
            except VerifierProtocolError:
                raise
            except (ConnectionError, OSError, socket.timeout):
                stale = getattr(self._tls, "conn", None)
                self._tls.conn = None
                if stale is not None:
                    try:
                        stale.close()
                    except OSError:
                        pass
                if self.metrics is not None:
                    self.metrics.verifier_reconnect_total.inc()
                if attempt + 1 >= self.max_attempts:
                    raise
                time.sleep(jittered_backoff(backoff, self._retry_rng))
                backoff = min(backoff * 2.0, self.RETRY_MAX_BACKOFF_S)
        if type_ == T_ERR:
            raise VerifierProtocolError(
                "verifier service error: "
                f"{bytes(payload).decode(errors='replace')}"
            )
        assert type_ == T_RESULT
        (echoed,) = struct.unpack_from("<I", payload)
        assert echoed == req_id, "verifier service response out of order"
        return payload[4:]

    # -- connection pool (async dispatch path) --

    def _pool_checkout(self) -> Optional[socket.socket]:
        """An idle pooled connection, a fresh one, or None when the pool is
        at its live-connection cap — the caller then falls back to the sync
        path's thread-local connection."""
        with self._pool_lock:
            if self._pool_conns:
                return self._pool_conns.pop()
            if self._pool_size >= self.MAX_POOLED_CONNS:
                return None
            self._pool_size += 1
        try:
            return self._connect()
        except BaseException:
            with self._pool_lock:
                self._pool_size -= 1
            raise

    def _pool_checkin(self, conn: socket.socket) -> None:
        with self._pool_lock:
            if len(self._pool_conns) < self.MAX_POOLED_CONNS:
                self._pool_conns.append(conn)
                return
            self._pool_size -= 1
        try:
            conn.close()
        except OSError:
            pass

    def _pool_discard(self, conn: socket.socket) -> None:
        with self._pool_lock:
            self._pool_size -= 1
        try:
            conn.close()
        except OSError:
            pass

    # -- frame building --

    def _pack_request(self, public_keys, digests, signatures, req_id, n):
        """Frame one request directly into this thread's reusable wire
        buffer and return a memoryview of it, or None when the batch cannot
        ride the service wire format (non-digest messages -> local oracle).
        Each digest / signature / key is slice-assigned into the buffer
        exactly ONCE, and the socket sends straight from the buffer."""
        if not all(len(d) == 32 for d in digests):
            # The service's fixed wire format carries 32-byte digests
            # (every deployed call site signs blake2b-256); anything else
            # verifies locally on the CPU oracle.
            return None
        indices = [self._index.get(pk) for pk in public_keys]
        indexed = all(i is not None for i in indices)
        rec = _IDX_REC if indexed else _RAW_REC
        total = 5 + 8 + n * rec
        buf = self._wire("pack").reserve(total)
        struct.pack_into(
            "<IBII", buf, 0,
            total - 5, T_VERIFY if indexed else T_RAW, req_id, n,
        )
        off = 13
        if indexed:
            for idx, digest, sig in zip(indices, digests, signatures):
                struct.pack_into("<H", buf, off, idx)
                buf[off + 2:off + 34] = digest
                buf[off + 34:off + 98] = sig
                off += _IDX_REC
        else:
            for pk, digest, sig in zip(public_keys, digests, signatures):
                buf[off:off + 32] = pk
                buf[off + 32:off + 64] = digest
                buf[off + 64:off + 128] = sig
                off += _RAW_REC
        return memoryview(buf)[:total]

    # -- SignatureVerifier surface --

    def warmup(self) -> None:
        """Connect + HELLO: returns once the service's runtime is warm."""
        self._conn()

    def verify_signatures_async(self, public_keys, digests, signatures):
        """Staged dispatch: send the request now (on a pooled connection the
        handle carries) and read the reply at ``result()``.  A send failure
        here falls back to the deferred sync path, which owns the full
        reconnect-retry budget."""
        n = len(signatures)
        if n == 0:
            return CompletedDispatch([])
        req_id = next(self._async_req_ids)
        frame = self._pack_request(
            public_keys, digests, signatures, req_id, n
        )
        if frame is None:
            return DeferredDispatch(
                CpuSignatureVerifier().verify_signatures,
                public_keys, digests, signatures,
            )
        try:
            conn = self._pool_checkout()
        except VerifierProtocolError:
            raise
        except (ConnectionError, OSError, socket.timeout):
            # No reconnect count here: the deferred sync fallback runs the
            # full retry loop and accounts each torn-down attempt itself.
            conn = None
        if conn is None:
            return DeferredDispatch(
                self.verify_signatures, public_keys, digests, signatures
            )
        try:
            conn.sendall(frame)
            self._count_wire("sent", len(frame))
        except (ConnectionError, OSError, socket.timeout):
            self._pool_discard(conn)
            if self.metrics is not None:
                self.metrics.verifier_reconnect_total.inc()
            return DeferredDispatch(
                self.verify_signatures, public_keys, digests, signatures
            )
        return _RemoteDispatch(
            self, conn, req_id, n, public_keys, digests, signatures
        )

    def verify_signatures(self, public_keys, digests, signatures) -> List[bool]:
        n = len(signatures)
        if n == 0:
            return []
        self._tls.req_id = req_id = getattr(self._tls, "req_id", 0) + 1
        frame = self._pack_request(
            public_keys, digests, signatures, req_id, n
        )
        if frame is None:
            return CpuSignatureVerifier().verify_signatures(
                public_keys, digests, signatures
            )
        oks = self._roundtrip(frame, req_id)
        assert len(oks) == n
        return [bool(b) for b in oks]


class _RemoteDispatch:
    """An in-flight request to the verifier service.

    ``result()`` reads the reply off the handle's own connection and returns
    it to the pool.  A connection failure at fetch time re-runs the whole
    request through the sync path's bounded reconnect-retry budget
    (re-verifying is idempotent)."""

    __slots__ = ("_client", "_conn", "_req_id", "_n", "_args")

    def __init__(self, client, conn, req_id, n, public_keys, digests,
                 signatures) -> None:
        self._client = client
        self._conn = conn
        self._req_id = req_id
        self._n = n
        self._args = (public_keys, digests, signatures)

    def result(self) -> List[bool]:
        client = self._client
        try:
            type_, payload = client._read_frame(self._conn)
        except VerifierProtocolError:
            client._pool_discard(self._conn)
            raise
        except (ConnectionError, OSError, socket.timeout):
            client._pool_discard(self._conn)
            if client.metrics is not None:
                client.metrics.verifier_reconnect_total.inc()
            return client.verify_signatures(*self._args)
        if type_ == T_ERR:
            client._pool_discard(self._conn)
            raise VerifierProtocolError(
                "verifier service error: "
                f"{bytes(payload).decode(errors='replace')}"
            )
        client._pool_checkin(self._conn)
        assert type_ == T_RESULT
        (echoed,) = struct.unpack_from("<I", payload)
        assert echoed == self._req_id, "verifier service response out of order"
        oks = payload[4:]
        assert len(oks) == self._n
        return [bool(b) for b in oks]

    def abandon(self) -> None:
        """Release without fetching: a connection with an unread response
        must never return to the pool, so it is discarded."""
        self._client._pool_discard(self._conn)


def run_service(socket_path: str, committee_keys: Optional[Sequence[bytes]] = None,
                metrics_port: Optional[int] = None, device=None) -> None:
    """Blocking entry point.  The backend runs on ``device`` (``cuda``
    unless given).  With ``metrics_port`` the service also exposes /metrics
    + /healthz (queue depth, per-connection in-flight, dispatch batch sizes,
    padding, and the device attribution's transfer bytes and builds)."""

    async def _main() -> None:
        metrics = None
        if metrics_port:
            from .metrics import Metrics, serve_metrics
            from .ops import ed25519

            metrics = Metrics()
            ed25519.install_device_attribution(metrics)
            await serve_metrics(metrics, "0.0.0.0", metrics_port)
        server = VerifierServer(
            socket_path, committee_keys=committee_keys, metrics=metrics,
            device=device,
        )
        await server.serve_forever()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass


def main(argv=None) -> int:
    """``python -m mysticeti_tpu_torch.verifier_service --socket PATH``."""
    parser = argparse.ArgumentParser(
        prog="python -m mysticeti_tpu_torch.verifier_service",
        description="shared per-host verifier service: one warmed card "
        "runtime serving every co-located validator over a unix socket "
        f"(set {ENV_SOCKET} on the nodes to use it)",
    )
    parser.add_argument("--socket", required=True, help="unix socket path")
    committee = parser.add_mutually_exclusive_group()
    committee.add_argument("--committee-path", default=None,
                           help="prewarm for this committee file while validators boot")
    committee.add_argument("--committee-size", type=int, default=None,
                           help="prewarm for the benchmark committee of this size")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="expose /metrics + /healthz")
    parser.add_argument("--device", default=None,
                        help="torch device of the backend (default cuda; cpu runs "
                        "the kernels' plain versions)")
    args = parser.parse_args(argv)
    from .committee import Committee
    from .tracing import setup_logging

    setup_logging()
    keys = None
    if args.committee_path:
        keys = Committee.load(args.committee_path).public_key_bytes()
    elif args.committee_size:
        keys = Committee.new_for_benchmarks(args.committee_size).public_key_bytes()
    run_service(args.socket, keys, metrics_port=args.metrics_port, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
