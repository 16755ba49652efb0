# lint: ignore-module[sim-taint] — real socket plane: the deterministic
# loop's selector refuses socket registration (_NullSelector), so nothing
# in this module can execute inside a seeded sim; simulated_network.py is
# the virtual-time twin.
"""Validator mesh networking: wire protocol, framing, TCP transport, RTT probes.

The port's copy of ``mysticeti_tpu.network``, whole: the frames are
byte-identical to the JAX package's, so endpoints of the two packages talk to
each other.  Capability parity with ``mysticeti-core/src/network.rs``:

* ``NetworkMessage`` taxonomy {SubscribeOwnFrom, Blocks, RequestBlocks,
  RequestBlocksResponse, BlockNotFound} (network.rs:35-46) + embedded
  Ping/Pong RTT probe (network.rs:33,324-406,563-574), and the soft wire
  extensions (helper streams, snapshots, timestamped frames, the client
  gateway, epoch info).  The codec covers every tag; of the modules that
  send the extensions (synchronizer, storage, ingress, reconfig), ingress,
  the gateway's, is not in the port yet.
* 4-byte length-prefixed frames, 16 MiB cap (network.rs:216,397-459)
* handshake magic + authority-index exchange (network.rs:214-217,244-292)
* per-peer reconnect-forever workers (network.rs:218-242)
* per-peer RTT estimate feeding the max-latency connection breaker
  (network.rs:378-381)

Transport design difference (documented, not accidental): the reference races
active+passive connections per peer; here the lower authority index dials and
the higher accepts — same full-mesh + reconnect capability with half the
connection-management states.  ``Connection`` is a pair of asyncio queues.

Broadcast-once data plane (endpoint-local; on-wire bytes unchanged):

* **encode-once fan-out** — a sender may enqueue one :class:`EncodedFrame`
  to several connections, so N-1 subscribers at the same cursor ship one
  serialization instead of re-encoding per peer (``synchronizer.FrameCache``);
* **scatter-gather write coalescing** — ``write_loop`` drains every queued
  message non-blocking and ships the batch as one
  ``writer.writelines([hdr, payload, ...])`` + a single ``drain()`` (headers
  are fresh immutable objects per write: a 3.12+ transport may hold frame N
  zero-copy in its buffer while we build frame N+1).  Ping/Pong jump the
  batch — RTT probes never queue behind bulk payloads;
* **zero-copy receive** — after the handshake the transport is switched onto
  :class:`_FrameReceiver` (``asyncio.BufferedProtocol``): the event loop
  ``recv_into``s directly into a reusable per-connection assembly buffer,
  frames surface as memoryviews, ``decode_message`` makes block payloads
  sub-views, and ``StatementBlock.from_bytes`` / ``from_bytes_many``
  materialize exactly one ``bytes`` per block.

The native data plane (``native/``) serves the Blocks-shaped frames when it
is built: ``encode_blocks_frame`` on send, ``split_frames`` in the receiver
and ``parse_blocks_spans`` in ``decode_message``; each has a pure-Python
twin with the same bytes and the same errors.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import random
import sys
import time
from typing import Dict, List, Optional, Tuple

from .serde import Reader, SerdeError, Writer
from .tracing import logger
from .utils.tasks import spawn_logged
from .types import BlockReference, RoundNumber, StatementBlock

log = logger(__name__)

HANDSHAKE_MAGIC = 0x7C9A_11B7
MAX_FRAME = 16 * 1024 * 1024
PING_INTERVAL_S = 30.0
# Byte cap on one coalesced writelines batch: enough to amortize the
# syscall/drain over many small frames, small enough that a deep queue of
# multi-MB frames still hits transport flow control per batch instead of
# buffering the whole queue.
MAX_COALESCE_BYTES = 1 << 20


def jittered_backoff(delay: float, rng: random.Random) -> float:
    """Uniform [0.5, 1.5)x jitter around an exponential-backoff delay.

    A bare doubling schedule synchronizes reconnect storms: every dialer that
    lost the same peer at the same moment retries on the same beat, hammering
    the recovering node in lockstep bursts.  The multiplicative jitter keeps
    the expected delay while decorrelating the fleet; callers pass a SEEDED
    rng so simulated runs stay reproducible.
    """
    return delay * (0.5 + rng.random())


_MSG_SUBSCRIBE = 1
_MSG_BLOCKS = 2
_MSG_REQUEST = 3
_MSG_RESPONSE = 4
_MSG_NOT_FOUND = 5
_MSG_PING = 6
_MSG_PONG = 7
_MSG_SUBSCRIBE_OTHERS = 8
_MSG_REQUEST_SNAPSHOT = 9
_MSG_SNAPSHOT = 10
_MSG_REQUEST_SNAPSHOT_STREAM = 11
_MSG_BLOCKS_TIMESTAMPED = 12
# Client gateway tags (ingress.py).  These ride the same length-prefixed
# framing and codec but flow ONLY on the gateway listener (client <->
# validator), never on the validator mesh — a mesh peer that predates them
# would reset the connection per the §7 soft-extension rule, and none is
# ever emitted there.
_MSG_GATEWAY_SUBMIT = 13
_MSG_GATEWAY_SUBMIT_REPLY = 14
_MSG_GATEWAY_SUBSCRIBE_COMMITS = 15
_MSG_GATEWAY_COMMITS = 16
# Epoch reconfiguration (reconfig.py): the sender's epoch + committee digest,
# exchanged right after the fixed 12-byte hello and re-broadcast on every
# epoch switch.  A soft wire extension per docs/wire-format.md §7 (tag 17):
# only sent when ``Parameters.reconfig`` is on; receivers that predate the
# tag reset the connection.
_MSG_EPOCH_INFO = 17


@dataclasses.dataclass(frozen=True)
class SubscribeOwnFrom:
    round: RoundNumber


@dataclasses.dataclass(frozen=True)
class SubscribeOthersFrom:
    """Helper-stream request (synchronizer.rs:169-205's dormant
    ``disseminate_others_blocks``, made live behind a Parameters knob):
    "relay AUTHORITY's blocks you hold, from this round on" — sent to a
    helper peer when the authority itself is unreachable.  A soft wire
    extension per docs/wire-format.md §7: receivers that predate the tag
    reset the connection, so senders only emit it when the knob is on."""

    authority: int
    round: RoundNumber


@dataclasses.dataclass(frozen=True)
class RequestSnapshot:
    """Snapshot catch-up ask (storage.py): "my committed height is
    ``commit_height``; if I am far behind, send me your commit baseline".
    A soft wire extension per docs/wire-format.md §7 — only sent when
    ``StorageParameters.snapshot_catchup`` is on; receivers that predate
    the tag reset the connection."""

    commit_height: int


@dataclasses.dataclass(frozen=True)
class SnapshotResponse:
    """The serving node's snapshot manifest (opaque canonical bytes).  The block window itself is only shipped on an
    explicit :class:`RequestSnapshotStream` — every qualifying peer answers
    the ask with a manifest (cheap), but the receiver adopts exactly one and
    pulls the bulk window from that peer alone."""

    manifest: bytes


@dataclasses.dataclass(frozen=True)
class RequestSnapshotStream:
    """Post-adoption bulk ask: "stream me every block you hold from
    ``from_round`` up" — sent to the ONE peer whose manifest was adopted;
    the window arrives as ordinary ``Blocks`` frames, decoded and re-hashed
    by the receiver like any push stream."""

    from_round: int


@dataclasses.dataclass(frozen=True)
class Blocks:
    blocks: Tuple[bytes, ...]  # serialized StatementBlocks (zero re-encode)


@dataclasses.dataclass(frozen=True)
class TimestampedBlocks(Blocks):
    """A ``Blocks`` push frame stamped with the sender's clocks at send time
    (fleet causal tracing, tools/fleet_trace.py): ``sent_monotonic_ns`` is
    the sender's runtime clock (detects wall-clock jumps between frames),
    ``sent_wall_ns`` its wall clock — the receiver's arrival time minus it
    is the RAW per-link transit the skew estimator aligns.  A soft wire
    extension per docs/wire-format.md §7 (tag 12): receivers that predate
    the tag reset the connection, so senders only emit it when
    ``SynchronizerParameters.timestamp_frames`` is on.  Subclasses
    ``Blocks`` so every receive path handles it unchanged."""

    sent_monotonic_ns: int = 0
    sent_wall_ns: int = 0


def wall_jump_us(prev: Tuple[int, int], cur: Tuple[int, int]) -> int:
    """|Δwall − Δmonotonic| between two consecutive sender stamp pairs
    ``(sent_monotonic_ns, sent_wall_ns)``, in microseconds.

    Between frames both sender clocks advance by real elapsed time, so the
    two deltas agree to within slew; a large disagreement means the
    sender's WALL clock stepped (NTP jump) between the frames — the
    receiver must discard that frame's wall-derived transit sample, which
    is the reason the monotonic stamp rides the wire at all."""
    dw = cur[1] - prev[1]
    dm = cur[0] - prev[0]
    return abs(dw - dm) // 1000


@dataclasses.dataclass(frozen=True)
class RequestBlocks:
    references: Tuple[BlockReference, ...]


@dataclasses.dataclass(frozen=True)
class RequestBlocksResponse:
    blocks: Tuple[bytes, ...]


@dataclasses.dataclass(frozen=True)
class BlockNotFound:
    references: Tuple[BlockReference, ...]


@dataclasses.dataclass(frozen=True)
class GatewaySubmit:
    """Client -> gateway: submit transactions to the admission-controlled
    mempool (wire tag 13, docs/wire-format.md §5b).  ``client`` names the
    fairness lane (empty = the connection's own lane); ``priority`` != 0
    asks for the priority drain class (subject to the lane caps — priority
    weights the round-robin, it does not bypass admission)."""

    client: bytes
    priority: int
    transactions: Tuple[bytes, ...]


# GatewaySubmitReply.status values (SUBMIT -> ACK/QUEUED/SHED).
GATEWAY_ACK = 0  # all accepted, mempool shallow
GATEWAY_QUEUED = 1  # all accepted, mempool past the queued watermark: slow down
GATEWAY_SHED = 2  # some/all rejected; retry_after_ms + reason say why/when


@dataclasses.dataclass(frozen=True)
class GatewaySubmitReply:
    """Gateway -> client: the typed submission verdict (wire tag 14).  A
    SHED reply is the explicit-backpressure contract: ``retry_after_ms``
    tells a closed-loop client when the admission controller expects
    capacity, ``reason`` (utf-8) names the first rejection cause."""

    status: int
    accepted: int
    shed: int
    retry_after_ms: int
    reason: bytes


@dataclasses.dataclass(frozen=True)
class GatewaySubscribeCommits:
    """Client -> gateway: stream commit notifications from ``from_height``
    (exclusive) on (wire tag 15).  Notifications carry the 16-byte ingress
    keys of committed transactions, the same keys the mempool dedups on.

    ``want_details`` (soft suffix, wire-format §5b) opts the subscriber in
    to the tag-16 detail suffix (leader round + commit timestamp) — an
    opt-in because a pre-r17 client would reset the connection on the
    longer notification frames (§7).  ``want_executed`` (second-tier soft
    suffix, r20) additionally opts in to the EXECUTED result suffix (the
    state root after the execution plane folded the commit) and, on the
    wire, forces the ``want_details`` byte to be written explicitly —
    suffix tiers are strictly ordered."""

    from_height: int
    want_details: int = 0
    want_executed: int = 0


@dataclasses.dataclass(frozen=True)
class GatewayCommitNotification:
    """Gateway -> client: transactions sequenced by the committed sub-dag at
    ``height`` (wire tag 16), identified by their 16-byte ingress keys.

    ``leader_round`` / ``committed_ts_ns`` form the soft detail suffix
    (wire-format §5b): the sequencing leader's round and the node's
    runtime commit timestamp, so clients compute finality without
    scraping ``/metrics``.  Encoded only when nonzero AND the subscriber
    asked (``want_details``); absent on the wire they decode as 0.

    ``executed_root`` is the second-tier EXECUTED result suffix (r20): the
    execution plane's chained state root after folding this commit —
    non-empty only for ``want_executed`` subscribers on nodes running the
    execution state machine.  Writing it forces the detail pair onto the
    wire (tiers are strictly ordered); absent it decodes as ``b""``.  A
    notification with ``height > 0`` and NO keys is the synthetic resume
    reply: it pins the node's current executed height/root for a
    resuming subscriber."""

    height: int
    keys: Tuple[bytes, ...]
    leader_round: int = 0
    committed_ts_ns: int = 0
    executed_root: bytes = b""


@dataclasses.dataclass(frozen=True)
class EpochInfo:
    """Sender's reconfiguration coordinates (wire tag 17): current epoch and
    the 32-byte committee digest (reconfig.committee_digest).  Advisory —
    a mismatch is logged and counted, never a reason to sever (the peer may
    simply not have processed the boundary commit yet; the committed
    sequence itself converges the fleet)."""

    epoch: int
    digest: bytes


@dataclasses.dataclass(frozen=True)
class Ping:
    nanos: int


@dataclasses.dataclass(frozen=True)
class Pong:
    nanos: int


NetworkMessage = object


def encode_message(msg: NetworkMessage) -> bytes:
    if _native_encode_frame is not None:
        # Native whole-frame serialization for the Blocks-shaped fan-out
        # payloads (tags 2/4/12): one call builds the entire body with the
        # GIL released instead of a per-block Writer append loop.
        # Byte-identical to the Writer path below — pinned by the golden
        # corpus and the data-plane parity suite.  Exact type checks: a
        # TimestampedBlocks IS a Blocks (subclass), so dispatch must not
        # collapse the stamped header.
        t = type(msg)
        if t is Blocks or t is RequestBlocksResponse:
            return _native_encode_frame(
                _MSG_BLOCKS if t is Blocks else _MSG_RESPONSE,
                False, 0, 0, msg.blocks,
            )
        if t is TimestampedBlocks:
            return _native_encode_frame(
                _MSG_BLOCKS_TIMESTAMPED, True,
                msg.sent_monotonic_ns, msg.sent_wall_ns, msg.blocks,
            )
    w = Writer()
    if isinstance(msg, SubscribeOwnFrom):
        w.u8(_MSG_SUBSCRIBE).u64(msg.round)
    elif isinstance(msg, SubscribeOthersFrom):
        w.u8(_MSG_SUBSCRIBE_OTHERS).u64(msg.authority).u64(msg.round)
    elif isinstance(msg, TimestampedBlocks):
        # Before the Blocks branch: a TimestampedBlocks IS a Blocks.
        w.u8(_MSG_BLOCKS_TIMESTAMPED)
        w.u64(msg.sent_monotonic_ns).u64(msg.sent_wall_ns)
        w.u32(len(msg.blocks))
        for b in msg.blocks:
            w.bytes(b)
    elif isinstance(msg, Blocks):
        w.u8(_MSG_BLOCKS).u32(len(msg.blocks))
        for b in msg.blocks:
            w.bytes(b)
    elif isinstance(msg, RequestBlocks):
        w.u8(_MSG_REQUEST).u32(len(msg.references))
        for r in msg.references:
            r.encode(w)
    elif isinstance(msg, RequestBlocksResponse):
        w.u8(_MSG_RESPONSE).u32(len(msg.blocks))
        for b in msg.blocks:
            w.bytes(b)
    elif isinstance(msg, BlockNotFound):
        w.u8(_MSG_NOT_FOUND).u32(len(msg.references))
        for r in msg.references:
            r.encode(w)
    elif isinstance(msg, Ping):
        w.u8(_MSG_PING).u64(msg.nanos)
    elif isinstance(msg, Pong):
        w.u8(_MSG_PONG).u64(msg.nanos)
    elif isinstance(msg, RequestSnapshot):
        w.u8(_MSG_REQUEST_SNAPSHOT).u64(msg.commit_height)
    elif isinstance(msg, SnapshotResponse):
        w.u8(_MSG_SNAPSHOT).bytes(msg.manifest)
    elif isinstance(msg, RequestSnapshotStream):
        w.u8(_MSG_REQUEST_SNAPSHOT_STREAM).u64(msg.from_round)
    elif isinstance(msg, EpochInfo):
        w.u8(_MSG_EPOCH_INFO).u64(msg.epoch).bytes(msg.digest)
    elif isinstance(msg, GatewaySubmit):
        w.u8(_MSG_GATEWAY_SUBMIT).bytes(msg.client).u8(1 if msg.priority else 0)
        w.u32(len(msg.transactions))
        for tx in msg.transactions:
            w.bytes(tx)
    elif isinstance(msg, GatewaySubmitReply):
        w.u8(_MSG_GATEWAY_SUBMIT_REPLY).u8(msg.status)
        w.u32(msg.accepted).u32(msg.shed).u64(msg.retry_after_ms)
        w.bytes(msg.reason)
    elif isinstance(msg, GatewaySubscribeCommits):
        w.u8(_MSG_GATEWAY_SUBSCRIBE_COMMITS).u64(msg.from_height)
        # Soft suffixes (§5b): omitted when default so pre-r17 gateways
        # (and the roundtrip equality tests) see the original short frame.
        # The second tier (want_executed, r20) forces the first byte to be
        # written explicitly — a reader cannot skip a tier.
        if msg.want_executed:
            w.u8(1 if msg.want_details else 0).u8(1)
        elif msg.want_details:
            w.u8(1)
    elif isinstance(msg, GatewayCommitNotification):
        w.u8(_MSG_GATEWAY_COMMITS).u64(msg.height).u32(len(msg.keys))
        for key in msg.keys:
            w.bytes(key)
        # Soft suffixes (§5b): leader round + commit timestamp, emitted only
        # to subscribers that sent want_details (the gateway constructs
        # default-0 notifications for everyone else).  The EXECUTED result
        # suffix (r20) forces the detail pair onto the wire even when zero.
        if msg.executed_root:
            w.u64(msg.leader_round).u64(msg.committed_ts_ns)
            w.bytes(msg.executed_root)
        elif msg.leader_round or msg.committed_ts_ns:
            w.u64(msg.leader_round).u64(msg.committed_ts_ns)
    else:  # pragma: no cover
        raise SerdeError(f"unknown message {type(msg)}")
    return w.finish()


def decode_message(data) -> NetworkMessage:
    """Decode one frame payload (``bytes`` or ``memoryview``).

    With a memoryview input — the zero-copy receive path — the block
    payloads inside ``Blocks``/``RequestBlocksResponse`` come back as
    sub-views over the caller's buffer; ``StatementBlock.from_bytes``
    materializes each exactly once for the canonical cache.  Everything
    else (references, digests, the snapshot manifest) is materialized here.
    """
    if _native_parse_spans is not None and len(data) > 0 \
            and data[0] in _NATIVE_PARSE_TAGS:
        # Native batched parse for the Blocks-shaped payloads: the whole
        # body is validated in C (GIL released for the walk) and only the
        # per-block sub-views are built in Python — the last step that
        # must touch Python objects.  Rejection cases and error messages
        # are byte-identical to the Reader path (parity corpus).
        try:
            tag, mono_ns, wall_ns, spans = _native_parse_spans(data)
        except ValueError as exc:
            raise SerdeError(str(exc)) from None
        blocks = tuple(data[off : off + ln] for off, ln in spans)
        if tag == _MSG_BLOCKS:
            return Blocks(blocks)
        if tag == _MSG_RESPONSE:
            return RequestBlocksResponse(blocks)
        return TimestampedBlocks(
            blocks, sent_monotonic_ns=mono_ns, sent_wall_ns=wall_ns
        )
    r = Reader(data)
    tag = r.u8()
    if tag == _MSG_SUBSCRIBE:
        msg: NetworkMessage = SubscribeOwnFrom(r.u64())
    elif tag == _MSG_SUBSCRIBE_OTHERS:
        msg = SubscribeOthersFrom(r.u64(), r.u64())
    elif tag == _MSG_BLOCKS:
        msg = Blocks(tuple(r.bytes() for _ in range(r.u32())))
    elif tag == _MSG_REQUEST:
        msg = RequestBlocks(tuple(BlockReference.decode(r) for _ in range(r.u32())))
    elif tag == _MSG_RESPONSE:
        msg = RequestBlocksResponse(tuple(r.bytes() for _ in range(r.u32())))
    elif tag == _MSG_NOT_FOUND:
        msg = BlockNotFound(tuple(BlockReference.decode(r) for _ in range(r.u32())))
    elif tag == _MSG_PING:
        msg = Ping(r.u64())
    elif tag == _MSG_PONG:
        msg = Pong(r.u64())
    elif tag == _MSG_REQUEST_SNAPSHOT:
        msg = RequestSnapshot(r.u64())
    elif tag == _MSG_SNAPSHOT:
        # Manifests are materialized at decode (never a view): the adopted
        # one is persisted to the WAL and must outlive the receive buffer.
        msg = SnapshotResponse(bytes(r.bytes()))
    elif tag == _MSG_REQUEST_SNAPSHOT_STREAM:
        msg = RequestSnapshotStream(r.u64())
    elif tag == _MSG_EPOCH_INFO:
        msg = EpochInfo(r.u64(), bytes(r.bytes()))
    elif tag == _MSG_BLOCKS_TIMESTAMPED:
        monotonic_ns, wall_ns = r.u64(), r.u64()
        msg = TimestampedBlocks(
            tuple(r.bytes() for _ in range(r.u32())),
            sent_monotonic_ns=monotonic_ns,
            sent_wall_ns=wall_ns,
        )
    elif tag == _MSG_GATEWAY_SUBMIT:
        # Materialized (never views): submitted transactions outlive the
        # receive buffer — they sit in the mempool until proposed.
        client = bytes(r.bytes())
        priority = r.u8()
        msg = GatewaySubmit(
            client, priority, tuple(bytes(r.bytes()) for _ in range(r.u32()))
        )
    elif tag == _MSG_GATEWAY_SUBMIT_REPLY:
        msg = GatewaySubmitReply(
            r.u8(), r.u32(), r.u32(), r.u64(), bytes(r.bytes())
        )
    elif tag == _MSG_GATEWAY_SUBSCRIBE_COMMITS:
        from_height = r.u64()
        # §5b suffixes, tier by tier: absent on frames from older clients.
        want_details = r.u8() if not r.done() else 0
        want_executed = r.u8() if not r.done() else 0
        msg = GatewaySubscribeCommits(from_height, want_details, want_executed)
    elif tag == _MSG_GATEWAY_COMMITS:
        height = r.u64()
        keys = tuple(bytes(r.bytes()) for _ in range(r.u32()))
        if not r.done():
            # §5b suffixes: leader round + commit timestamp, then the
            # optional EXECUTED result root (r20).
            leader_round, committed_ts_ns = r.u64(), r.u64()
            executed_root = bytes(r.bytes()) if not r.done() else b""
            msg = GatewayCommitNotification(
                height, keys, leader_round, committed_ts_ns, executed_root
            )
        else:
            msg = GatewayCommitNotification(height, keys)
    else:
        raise SerdeError(f"unknown message tag {tag}")
    r.expect_done()
    return msg


class EncodedFrame:
    """A message plus its cached frame payload (encode-once fan-out).

    A sender hands the SAME EncodedFrame object to every subscriber at one
    cursor; the TCP ``write_loop`` ships ``payload`` without re-encoding,
    while an in-process link can deliver ``message`` object-identically and
    never pay for serialization at all (``payload`` is built lazily on first
    wire access).  ``payload`` is byte-identical to
    ``encode_message(message)`` — pinned by the golden-corpus test."""

    __slots__ = ("message", "_payload")

    def __init__(self, message: NetworkMessage, payload: Optional[bytes] = None) -> None:
        self.message = message
        self._payload = payload

    @property
    def payload(self) -> bytes:
        if self._payload is None:
            self._payload = encode_message(self.message)
        return self._payload


def frame_payload(msg: NetworkMessage) -> bytes:
    """The wire payload for a queued message: the cached bytes of an
    :class:`EncodedFrame`, a fresh encode for everything else."""
    if type(msg) is EncodedFrame:
        return msg.payload
    return encode_message(msg)


class _SendQueue(asyncio.Queue):
    """Bounded send queue with a capped urgent lane.

    ``put_front_nowait`` enqueues ahead of everything already queued and
    ignores the bulk bound — reserved for Ping/Pong, so an RTT probe can
    never sit behind a saturated bulk backlog inflating the latency
    estimate into the 5 s breaker (the snapshot-stream false-trip).  The
    lane has its OWN small cap: the echo path answers every received Ping
    with a Pong, and without a bound a peer flooding Pings while refusing
    to read would grow the deque without limit (the old per-message path
    backpressured via the full queue).  Legitimate traffic is one probe
    per ``PING_INTERVAL_S`` plus its echo — nowhere near the cap; over it,
    the probe is dropped, which the protocol tolerates by design.
    Mirrors ``put_nowait`` on the documented-stable asyncio.Queue
    internals (``_queue`` deque + getter wakeup)."""

    URGENT_CAP = 16

    def _init(self, maxsize: int) -> None:
        super()._init(maxsize)
        self.urgent_queued = 0

    def _get(self):
        item = self._queue.popleft()
        if type(item) is Ping or type(item) is Pong:
            self.urgent_queued -= 1
        return item

    def put_front_nowait(self, item) -> bool:
        if self.urgent_queued >= self.URGENT_CAP:
            return False
        self.urgent_queued += 1
        self._queue.appendleft(item)
        self._unfinished_tasks += 1
        self._finished.clear()
        self._wakeup_next(self._getters)
        return True


def _is_urgent(msg: NetworkMessage) -> bool:
    return type(msg) is Ping or type(msg) is Pong


class Connection:
    """One live peer link: outgoing via ``send``, incoming via ``receiver``.

    The transport (TCP worker or simulated link) feeds ``receiver`` and drains
    the internal send queue; when either side drops, the connection closes and
    the owning worker establishes a fresh Connection object (network.rs:195-242
    Worker semantics).
    """

    def __init__(self, peer: int, latency_getter=None, metrics=None) -> None:
        self.peer = peer
        self.sender: asyncio.Queue = _SendQueue(maxsize=1024)
        self.receiver: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._closed = asyncio.Event()
        self._latency_getter = latency_getter
        self.metrics = metrics

    def try_send(self, msg: NetworkMessage) -> bool:
        """Non-blocking send; drops (returns False) when the peer is slow —
        the reference's bounded-channel backpressure behavior.  Drops are
        counted on ``connection_send_drops_total{peer}`` (they were silent:
        a fleet losing fetch requests to backpressure looked identical to
        one that never sent them)."""
        if self.is_closed():
            return False
        if _is_urgent(msg):
            if self.sender.put_front_nowait(msg):
                return True
            self._count_drop()
            return False
        try:
            self.sender.put_nowait(msg)
            return True
        except asyncio.QueueFull:
            self._count_drop()
            return False

    def _count_drop(self) -> None:
        if self.metrics is not None:
            self.metrics.connection_send_drops_total.labels(
                str(self.peer)
            ).inc()

    async def send(self, msg: NetworkMessage) -> None:
        if self.is_closed():
            return
        if _is_urgent(msg):
            # Ping/Pong jump the queue AND never block behind a full one —
            # a saturated bulk stream must not delay (or deadlock) the RTT
            # probe that decides whether this link is healthy.  Beyond the
            # urgent-lane cap (a ping flood) the probe is dropped, never
            # queued unboundedly.
            if not self.sender.put_front_nowait(msg):
                self._count_drop()
            return
        await self.sender.put(msg)

    async def recv(self) -> Optional[NetworkMessage]:
        get = asyncio.ensure_future(self.receiver.get())
        closed = asyncio.ensure_future(self._closed.wait())
        try:
            done, pending = await asyncio.wait(
                {get, closed}, return_when=asyncio.FIRST_COMPLETED
            )
        except asyncio.CancelledError:
            # A connection task torn down mid-recv (node crash/stop) must not
            # orphan the two helper tasks — they would linger pending until
            # loop close ("Task was destroyed but it is pending").
            get.cancel()
            closed.cancel()
            raise
        for p in pending:
            p.cancel()
        if get in done:
            return self._unwrap(get.result())
        # Drain anything already delivered before reporting closure.
        try:
            return self._unwrap(self.receiver.get_nowait())
        except asyncio.QueueEmpty:
            return None

    @staticmethod
    def _unwrap(msg):
        """Simulated links deliver the disseminator's EncodedFrame objects
        verbatim (no serialization in-process); consumers see the message,
        keeping the sim a drop-in for the TCP transport."""
        if type(msg) is EncodedFrame:
            return msg.message
        return msg

    def latency(self) -> float:
        """Smoothed RTT estimate in seconds (inf until first pong)."""
        if self._latency_getter is not None:
            return self._latency_getter()
        return float("inf")

    def close(self) -> None:
        self._closed.set()

    def is_closed(self) -> bool:
        return self._closed.is_set()


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "little")
    if length > MAX_FRAME:
        raise SerdeError(f"frame of {length} bytes exceeds MAX_FRAME")
    return await reader.readexactly(length)


def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(len(payload).to_bytes(4, "little") + payload)


class _FrameReceiver(asyncio.BufferedProtocol):
    """Zero-copy mesh frame receiver: ``recv_into`` a reusable buffer.

    After the stream handshake the connection's transport is switched onto
    this protocol (``transport.set_protocol`` retargets the selector's
    read-ready path to ``get_buffer``/``buffer_updated``): the event loop
    then ``recv_into``s DIRECTLY into the per-connection assembly buffer —
    no StreamReader ``feed_data`` append copy, no ``readexactly`` join
    copy.  ``read_frame`` yields complete frames as memoryviews over the
    buffer; ``decode_message`` turns block payloads into sub-views and
    ``StatementBlock.from_bytes`` materializes exactly one ``bytes`` per
    block for the canonical cache, so a disseminated block's bytes are
    copied once between the kernel and the DAG.

    Buffer lifecycle: the assembly buffer is reused across frames.  When
    compaction or growth would disturb a frame view still alive downstream
    (deep receive pipelining holds decoded-but-unconsumed frames), the
    unparsed tail moves to a FRESH buffer and the old one is left to the
    GC with its views — detected by refcount: the buffer has exactly two
    references (the attribute + the check's argument) when no view is
    exported.  Views never outlive their backing store.

    Division of labor with the streams machinery: the WRITE half stays on
    the original ``StreamWriter``/``StreamReaderProtocol`` — pause/resume
    and connection_lost are forwarded so ``writer.drain()`` keeps its flow
    -control contract.  READ-side backpressure is ours: parsed-but-unread
    frames beyond ``MAX_BUFFERED_FRAMES`` pause the transport until
    ``read_frame`` drains them (the old path got the same effect from the
    StreamReader high-water mark).
    """

    MIN_BUF = 64 * 1024
    MAX_BUFFERED_FRAMES = 64

    def __init__(self, stream_protocol, transport) -> None:
        self._stream_protocol = stream_protocol
        self._transport = transport
        self._buf = bytearray(self.MIN_BUF)
        self._start = 0  # offset of the first unparsed byte
        self._have = 0  # offset one past the last filled byte
        self._frames: collections.deque = collections.deque()
        self._waiter: Optional[asyncio.Future] = None
        self._exc: Optional[BaseException] = None
        self._eof = False
        self._paused = False
        # True between get_buffer and the matching buffer_updated: the
        # event loop holds a view of _buf for an in-flight recv.  On the
        # selector loop the pair is synchronous, but a proactor loop keeps
        # the view across the overlapped recv — swapping _buf then would
        # send incoming bytes into the orphaned buffer.
        self._recv_pending = False

    @classmethod
    def attach(cls, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        """Switch a handshaken stream connection to zero-copy reads.

        Returns None when the transport cannot be switched (mock streams in
        tests) — the caller falls back to the ``_read_frame(reader)`` stream
        path, frame-for-frame compatible."""
        transport = getattr(writer, "transport", None)
        buffered = getattr(reader, "_buffer", None)
        if (
            transport is None
            or not isinstance(buffered, bytearray)
            or not hasattr(transport, "set_protocol")
            or not hasattr(transport, "get_protocol")
        ):
            return None
        try:
            receiver = cls(transport.get_protocol(), transport)
            # Switch FIRST: if the transport refuses (base-class stub, a
            # wrapper), the StreamReader's buffer is untouched and the
            # stream fallback stays whole.  The switch and the drain below
            # run in one synchronous step, so no data callback can land
            # between them.
            transport.set_protocol(receiver)
        except (AttributeError, NotImplementedError):
            return None
        # Bytes the stream consumed off the socket between the handshake
        # and the switch belong to us now — seed the assembly buffer so
        # nothing is lost or read twice.
        if buffered:
            receiver._reserve(len(buffered))
            receiver._buf[: len(buffered)] = buffered
            receiver._have = len(buffered)
            del buffered[:]
            receiver._parse()
        if not receiver._paused:
            # The StreamReader may have paused the transport itself (a
            # handshake-window burst past 2x its limit); its pause is not
            # ours and nothing else would ever resume it — the read side
            # would stall forever while pings keep flowing out.
            try:
                transport.resume_reading()
            except Exception:  # noqa: BLE001 - not paused / closing: fine
                pass
        return receiver

    # -- consumer side --

    async def read_frame(self) -> memoryview:
        """Next complete frame payload (header stripped) as a memoryview.

        Raises ``IncompleteReadError`` on EOF and the stored exception on
        transport error — the same failure surface ``_read_frame`` has."""
        while not self._frames:
            if self._exc is not None:
                raise self._exc
            if self._eof:
                raise asyncio.IncompleteReadError(b"", 4)
            self._waiter = asyncio.get_event_loop().create_future()
            try:
                await self._waiter
            finally:
                self._waiter = None
        frame = self._frames.popleft()
        if (
            not self._frames
            and self._start == self._have
            and len(self._buf) > 8 * self.MIN_BUF
            and not self._recv_pending
        ):
            # A past jumbo frame grew the assembly buffer; once the backlog
            # fully clears, swap in a fresh small one — a 50-peer node
            # would otherwise pin one jumbo buffer per connection forever.
            # Always safe: live downstream views (including the frame just
            # popped) keep the OLD buffer alive; we only stop writing to it.
            self._buf = bytearray(self.MIN_BUF)
            self._start = self._have = 0
        if self._paused and len(self._frames) <= self.MAX_BUFFERED_FRAMES // 2:
            self._paused = False
            try:
                self._transport.resume_reading()
            except Exception:  # noqa: BLE001 - transport already gone
                pass
        return frame

    # -- BufferedProtocol callbacks (event-loop thread) --

    def get_buffer(self, sizehint: int) -> memoryview:
        tail = self._have - self._start
        need = 4096
        if tail >= 4:
            # A partial frame is pending: reserve enough for its remainder
            # so large frames assemble without quadratic regrowth.  An
            # over-MAX length is not our problem here — _parse rejects it.
            length = int.from_bytes(
                self._buf[self._start : self._start + 4], "little"
            )
            if length <= MAX_FRAME:
                need = max(need, 4 + length - tail)
        if len(self._buf) - self._have < need:
            self._reserve(need)
        self._recv_pending = True
        return memoryview(self._buf)[self._have :]

    def buffer_updated(self, nbytes: int) -> None:
        self._recv_pending = False
        self._have += nbytes
        self._parse()

    def eof_received(self) -> bool:
        self._eof = True
        self._wake()
        return False  # a half-closed mesh peer is a dead peer: close

    def connection_lost(self, exc: Optional[BaseException]) -> None:
        self._recv_pending = False
        if exc is not None:
            self._exc = exc
        self._eof = True
        self._wake()
        # The write half (StreamWriter.drain / wait_closed) still lives on
        # the original protocol: it must observe the loss.
        self._stream_protocol.connection_lost(exc)

    def pause_writing(self) -> None:
        self._stream_protocol.pause_writing()

    def resume_writing(self) -> None:
        self._stream_protocol.resume_writing()

    # -- internals --

    def _wake(self) -> None:
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    def _views_exported(self) -> bool:
        # Two references = self._buf + getrefcount's argument; anything
        # beyond that is a parsed frame view (queued here or held by a
        # consumer downstream).
        return sys.getrefcount(self._buf) > 2 or bool(self._frames)

    def _reserve(self, need: int) -> None:
        """Ensure ``need`` writable bytes after ``_have``, compacting the
        unparsed tail to offset 0 (into a fresh buffer if live views pin
        the current one)."""
        tail = self._have - self._start
        cap = len(self._buf)
        want = tail + need
        if want > cap:
            cap = max(self.MIN_BUF, 1 << (want - 1).bit_length())
        if cap != len(self._buf) or self._views_exported():
            new = bytearray(cap)
            new[:tail] = memoryview(self._buf)[self._start : self._have]
            self._buf = new
        elif self._start:
            self._buf[:tail] = self._buf[self._start : self._have]
        self._start, self._have = 0, tail

    def _parse(self) -> None:
        if _native_split_frames is not None:
            # Native batch split: one call walks the whole assembly buffer
            # and returns every complete frame's (offset, length) span; only
            # the memoryview wrapping — the step that must touch Python
            # objects — stays here.  All slices share one managed buffer,
            # which keeps the `_views_exported` refcount probe truthful
            # (any live slice pins the bytearray's refcount above 2).
            spans, start, oversized = _native_split_frames(
                self._buf, self._start, self._have, MAX_FRAME
            )
            if oversized:
                self._exc = SerdeError(
                    f"frame of {oversized} bytes exceeds MAX_FRAME"
                )
                self._wake()
                self._transport.close()
                return
            if spans:
                view = memoryview(self._buf)
                for off, length in spans:
                    self._frames.append(view[off : off + length])
            self._start = start
        else:
            buf, start, have = self._buf, self._start, self._have
            while have - start >= 4:
                length = int.from_bytes(buf[start : start + 4], "little")
                if length > MAX_FRAME:
                    self._exc = SerdeError(
                        f"frame of {length} bytes exceeds MAX_FRAME"
                    )
                    self._wake()
                    self._transport.close()
                    return
                end = start + 4 + length
                if end > have:
                    break
                self._frames.append(memoryview(buf)[start + 4 : end])
                start = end
            self._start = start
        if self._frames:
            self._wake()
            if (
                len(self._frames) > self.MAX_BUFFERED_FRAMES
                and not self._paused
            ):
                self._paused = True
                try:
                    self._transport.pause_reading()
                except Exception:  # noqa: BLE001 - transport already gone
                    pass


class TcpNetwork:
    """Full-mesh TCP among the committee (network.rs:48-292).

    ``connections`` is an asyncio.Queue of fresh Connection objects handed to
    the node orchestration (net_sync.rs consumes them identically).
    """

    def __init__(
        self,
        authority: int,
        addresses: List[Tuple[str, int]],
        metrics=None,
        max_latency_s: float = 5.0,
    ) -> None:
        self.authority = authority
        self.addresses = addresses
        self.connections: asyncio.Queue = asyncio.Queue()
        self.metrics = metrics
        self.max_latency_s = max_latency_s
        self._latency: Dict[int, float] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: List[asyncio.Task] = []
        self._stopped = False

    @classmethod
    async def start(cls, authority, addresses, metrics=None, **kwargs) -> "TcpNetwork":
        net = cls(authority, addresses, metrics, **kwargs)
        host, port = addresses[authority]
        net._server = await asyncio.start_server(
            net._handle_inbound, host="0.0.0.0", port=port
        )
        # Dial every higher-index peer; lower-index peers dial us.
        for peer in range(len(addresses)):
            if peer > authority:
                net._tasks.append(
                    spawn_logged(net._dial_worker(peer), log, name=f"dial {peer}")
                )
        return net

    # -- inbound --

    async def _handle_inbound(self, reader, writer) -> None:
        try:
            hello = await asyncio.wait_for(reader.readexactly(12), timeout=5.0)
            magic = int.from_bytes(hello[:4], "little")
            peer = int.from_bytes(hello[4:], "little")
            if magic != HANDSHAKE_MAGIC or peer >= len(self.addresses):
                writer.close()
                return
            _write_frame(
                writer,
                HANDSHAKE_MAGIC.to_bytes(4, "little")
                + self.authority.to_bytes(8, "little"),
            )
            await writer.drain()
        except Exception:
            writer.close()
            return
        await self._run_peer(peer, reader, writer)

    # -- outbound --

    async def _dial_worker(self, peer: int) -> None:
        """Reconnect-forever loop (network.rs:218-242), with seeded jitter on
        the backoff (the simulator's loop RNG when present, else a
        per-(dialer, peer) seed) so fleet-wide reconnect storms decorrelate."""
        rng = getattr(asyncio.get_event_loop(), "rng", None) or random.Random(
            (self.authority << 20) ^ peer
        )
        delay = 0.1
        while not self._stopped:
            try:
                host, port = self.addresses[peer]
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(
                    HANDSHAKE_MAGIC.to_bytes(4, "little")
                    + self.authority.to_bytes(8, "little")
                )
                await writer.drain()
                ack = await asyncio.wait_for(_read_frame(reader), timeout=5.0)
                if (
                    int.from_bytes(ack[:4], "little") != HANDSHAKE_MAGIC
                    or int.from_bytes(ack[4:], "little") != peer
                ):
                    raise ConnectionError("bad handshake ack")
                delay = 0.1
                log.debug("dialed authority %d", peer)
                await self._run_peer(peer, reader, writer)
            except (OSError, asyncio.IncompleteReadError, ConnectionError, SerdeError,
                    asyncio.TimeoutError) as exc:
                log.debug("dial to authority %d failed: %r (retrying)", peer, exc)
            await asyncio.sleep(jittered_backoff(delay, rng))
            delay = min(delay * 2, 5.0)

    # -- shared read/write/ping loops --

    async def _run_peer(self, peer: int, reader, writer) -> None:
        conn = Connection(
            peer,
            latency_getter=lambda p=peer: self._latency.get(p, float("inf")),
            metrics=self.metrics,
        )
        await self.connections.put(conn)
        receiver = _FrameReceiver.attach(reader, writer)
        metrics = self.metrics
        recv_bytes = sent_bytes = coalesced = None
        if metrics is not None:
            recv_bytes = metrics.mesh_wire_bytes_total.labels("received")
            sent_bytes = metrics.mesh_wire_bytes_total.labels("sent")
            coalesced = metrics.mesh_frames_coalesced_total

        def _count_malformed() -> None:
            if metrics is not None:
                metrics.mysticeti_malformed_frames_total.labels(
                    str(peer)
                ).inc()

        async def read_loop():
            while True:
                try:
                    if receiver is not None:
                        frame = await receiver.read_frame()
                    else:
                        frame = await _read_frame(reader)
                except SerdeError as exc:
                    # Garbage or oversized length prefix: the stream is
                    # desynced beyond recovery — sever THIS connection
                    # (counted, attributed) and let the reconnect worker
                    # start clean.  That is the cap on malformed-frame
                    # handling: one bad frame, one severed connection,
                    # never an uncaught decode error.
                    log.warning(
                        "malformed frame from authority %d (%s): severing "
                        "connection", peer, exc,
                    )
                    _count_malformed()
                    return
                if recv_bytes is not None:
                    recv_bytes.inc(len(frame) + 4)
                try:
                    msg = decode_message(frame)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 - byzantine payload
                    # Undecodable payload inside a well-framed length: same
                    # verdict as a garbage prefix.  Catching broadly is the
                    # contract — no struct/decode error may escape the
                    # protocol callback path.
                    log.warning(
                        "undecodable frame payload from authority %d (%r): "
                        "severing connection", peer, exc,
                    )
                    _count_malformed()
                    return
                if isinstance(msg, Ping):
                    # Priority lane: the echo must not queue behind bulk
                    # frames or the peer's RTT estimate absorbs our send
                    # backlog (Connection.send front-queues Ping/Pong).
                    await conn.send(Pong(msg.nanos))
                    continue
                if isinstance(msg, Pong):
                    rtt = (time.monotonic_ns() - msg.nanos) / 1e9
                    prev = self._latency.get(peer)
                    self._latency[peer] = rtt if prev is None else 0.8 * prev + 0.2 * rtt
                    if self.metrics is not None:
                        self.metrics.connection_latency.labels(str(peer)).observe(rtt)
                    if rtt >= self.max_latency_s:
                        log.warning(
                            "latency breaker: authority %d RTT %.2fs >= %.2fs",
                            peer, rtt, self.max_latency_s,
                        )
                        raise ConnectionError("latency breaker tripped")
                    continue
                await conn.receiver.put(msg)

        async def write_loop():
            import contextlib

            encode_timer = (
                metrics.utilization_timer
                if metrics is not None
                else (lambda _name: contextlib.nullcontext())
            )
            while True:
                # Scatter-gather coalescing: drain the queue non-blocking
                # and ship the batch as one writelines + ONE drain — the
                # per-frame header+payload concat and per-frame drain were
                # a measurable share of mesh send CPU at load.  The batch
                # is byte-capped: the old per-frame drain throttled the
                # transport buffer one frame at a time, and an unbounded
                # drain of a deep queue of multi-MB frames would buffer
                # them ALL before the flow-control await.
                msg = await conn.sender.get()
                urgent_parts: List[bytes] = []
                parts: List[bytes] = []
                total = 0
                count = 0
                with encode_timer("net:mesh_encode"):
                    while True:
                        payload = frame_payload(msg)
                        # Ping/Pong lead the writelines batch (never behind
                        # bulk payloads); headers are fresh immutable
                        # objects per write (a 3.12+ transport may hold
                        # frame N zero-copy in its buffer while N+1 is
                        # built).
                        dest = urgent_parts if _is_urgent(msg) else parts
                        dest.append(len(payload).to_bytes(4, "little"))
                        dest.append(payload)
                        total += 4 + len(payload)
                        count += 1
                        if total >= MAX_COALESCE_BYTES:
                            break
                        try:
                            msg = conn.sender.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                writer.writelines(urgent_parts + parts)
                if sent_bytes is not None:
                    sent_bytes.inc(total)
                if coalesced is not None and count > 1:
                    coalesced.inc(count - 1)
                await writer.drain()

        async def ping_loop():
            while True:
                await conn.send(Ping(time.monotonic_ns()))
                await asyncio.sleep(PING_INTERVAL_S)

        tasks = [
            asyncio.ensure_future(read_loop()),
            asyncio.ensure_future(write_loop()),
            asyncio.ensure_future(ping_loop()),
        ]
        try:
            done, pending = await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in tasks:
                t.cancel()
            conn.close()
            writer.close()

    async def stop(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


# Native data-plane wiring (mirrors types.py's decoder gate): resolve the
# batched frame helpers once.  Each alias is None when the extension (or the
# specific function — build skew) is absent, and every call site above
# branches on that.
from .native import native as _native_mod  # noqa: E402

_NATIVE_PARSE_TAGS = frozenset(
    (_MSG_BLOCKS, _MSG_RESPONSE, _MSG_BLOCKS_TIMESTAMPED)
)
_native_encode_frame = None
_native_parse_spans = None
_native_split_frames = None
if _native_mod is not None:
    if hasattr(_native_mod, "encode_blocks_frame"):
        _native_encode_frame = _native_mod.encode_blocks_frame
    if hasattr(_native_mod, "parse_blocks_spans"):
        _native_parse_spans = _native_mod.parse_blocks_spans
    if hasattr(_native_mod, "split_frames"):
        _native_split_frames = _native_mod.split_frames
