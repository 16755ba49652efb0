"""The port's mesh transport and codec against the JAX package's.

``encode_message`` must give the JAX package's bytes for a corpus that covers
every wire tag (1-17), with and without the native encoder; ``decode_message``
must agree with it on every torn prefix of every frame (the same message or
the same error text); ``_FrameReceiver`` must cut any chunking of a frame
stream into the same frames and close the connection on an oversized one.
Then real loopback exchanges: ``Blocks`` and Ping/Pong between two port
``TcpNetwork`` endpoints (zero-copy receive, and the stream path kept for
transports that cannot be switched), and
``Blocks`` both ways between a port endpoint and a JAX-package endpoint.
Every comparison is exact: frames are bytes.
"""
import asyncio
import dataclasses
import os
import random

import pytest

import mysticeti_tpu.network as JN
import mysticeti_tpu.types as JT
from mysticeti_tpu.committee import Committee as JCommittee

import mysticeti_tpu_torch.network as PN
import mysticeti_tpu_torch.types as PT
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.serde import SerdeError

from test_mesh_data_plane import GOLDEN_CORPUS
from test_native_dataplane import GATEWAY_CORPUS

FULL_CORPUS = list(GOLDEN_CORPUS) + GATEWAY_CORPUS


def _to_port(obj):
    """The port's counterpart of a JAX-package message, field by field."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(PN, type(obj).__name__, None) or getattr(PT, type(obj).__name__)
        return cls(**{f.name: _to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_to_port(x) for x in obj)
    return obj


def _port_corpus():
    return [(_to_port(m), h) for m, h in FULL_CORPUS]


def test_corpus_covers_every_wire_tag():
    assert {bytes.fromhex(h)[0] for _, h in FULL_CORPUS} == set(range(1, 18))
    assert all(type(p).__module__ == "mysticeti_tpu_torch.network" for p, _ in _port_corpus())


def test_encode_message_is_byte_identical_to_the_jax_package(monkeypatch):
    assert PN._native_encode_frame is not None
    for (port_msg, hexpect), (jax_msg, _) in zip(_port_corpus(), FULL_CORPUS):
        frame = PN.encode_message(port_msg)
        assert frame.hex() == hexpect == JN.encode_message(jax_msg).hex(), type(port_msg).__name__
        assert PN.EncodedFrame(port_msg).payload == frame == PN.frame_payload(port_msg)
        assert PN.decode_message(frame) == port_msg
        assert PN.decode_message(memoryview(bytearray(frame))) == port_msg
    with monkeypatch.context() as m:
        m.setattr(PN, "_native_encode_frame", None)
        for port_msg, hexpect in _port_corpus():
            assert PN.encode_message(port_msg).hex() == hexpect


def test_encode_message_equals_the_jax_package_on_random_blocks():
    rng = random.Random(0xB1)
    for _ in range(30):
        blocks = tuple(rng.randbytes(rng.choice((0, 1, 64, 700))) for _ in range(rng.randrange(0, 9)))
        mono, wall = rng.randrange(2**64), rng.randrange(2**64)
        for name in ("Blocks", "RequestBlocksResponse"):
            assert PN.encode_message(getattr(PN, name)(blocks)) == \
                JN.encode_message(getattr(JN, name)(blocks))
        assert PN.encode_message(PN.TimestampedBlocks(blocks, mono, wall)) == \
            JN.encode_message(JN.TimestampedBlocks(blocks, mono, wall))


def _decoded(module, frame):
    try:
        return ("ok", repr(module.decode_message(frame)))
    except SerdeError as exc:
        return ("err", str(exc))
    except Exception as exc:  # noqa: BLE001 - the JAX package raises its own SerdeError class
        return ("err", str(exc)) if type(exc).__name__ == "SerdeError" else ("raised", repr(exc))


def test_decode_message_agrees_with_the_jax_package_on_torn_frames(monkeypatch):
    frames = [bytes.fromhex(h) for _, h in FULL_CORPUS]
    outcomes = []
    for frame in frames:
        for cut in range(1, len(frame) + 1):
            got = _decoded(PN, frame[:cut])
            assert got == _decoded(JN, frame[:cut]), (frame[0], cut)
            outcomes.append(got)
        assert _decoded(PN, frame + b"\x00") == _decoded(JN, frame + b"\x00")
    assert {kind for kind, _ in outcomes} == {"ok", "err"}
    assert _decoded(PN, b"\x63") == _decoded(JN, b"\x63") == ("err", "unknown message tag 99")
    with monkeypatch.context() as m:  # the Reader path gives the same errors
        m.setattr(PN, "_native_parse_spans", None)
        for frame in frames:
            for cut in range(1, len(frame)):
                assert _decoded(PN, frame[:cut]) == _decoded(JN, frame[:cut])


def test_decode_message_views_are_zero_copy_until_materialized():
    signers = JCommittee.benchmark_signers(4)
    genesis = [JT.StatementBlock.new_genesis(a).reference for a in range(4)]
    raw = JT.StatementBlock.build(0, 1, genesis, [JT.Share(b"tx" * 50)], signer=signers[0]).to_bytes()
    frame = bytearray(PN.encode_message(PN.Blocks((raw,))))
    msg = PN.decode_message(memoryview(frame))
    assert type(msg.blocks[0]) is memoryview
    (decoded,) = PT.StatementBlock.from_bytes_many(msg.blocks)
    del msg
    frame[:] = b"\x00" * len(frame)  # buffer reuse
    assert decoded.to_bytes() == raw


class _StubTransport:
    def __init__(self):
        self.closed = False
        self.paused = False

    def close(self):
        self.closed = True

    def pause_reading(self):
        self.paused = True

    def resume_reading(self):
        self.paused = False


def _drain_receiver(stream, chunks):
    recv = PN._FrameReceiver(object(), _StubTransport())
    pos = 0
    for size in chunks:
        chunk = stream[pos: pos + size]
        pos += len(chunk)
        while chunk:
            view = recv.get_buffer(len(chunk))
            n = min(len(view), len(chunk))
            view[:n] = chunk[:n]
            recv.buffer_updated(n)
            chunk = chunk[n:]
    return recv, [bytes(f) for f in recv._frames]


@pytest.mark.parametrize("native_split", [True, False])
def test_frame_receiver_holds_over_random_chunkings(native_split, monkeypatch):
    if not native_split:
        monkeypatch.setattr(PN, "_native_split_frames", None)
    payloads = [bytes.fromhex(h) for _, h in FULL_CORPUS]
    payloads.append(os.urandom(200_000))  # grows the 64 KiB assembly buffer
    stream = b"".join(len(p).to_bytes(4, "little") + p for p in payloads)
    rng = random.Random(0xF2)
    chunkings = [[len(stream)], [4096] * (len(stream) // 4096 + 1)]
    for _ in range(6):
        chunks, left = [], len(stream)
        while left:
            n = min(left, rng.choice((1, 3, 40, 5000, 70_000)))
            chunks.append(n)
            left -= n
        chunkings.append(chunks)
    for chunks in chunkings:
        recv, frames = _drain_receiver(stream, chunks)
        assert frames == payloads
        assert recv._start == recv._have
    cut = len(stream) - 3
    recv, frames = _drain_receiver(stream[:cut], [cut])
    assert frames == payloads[:-1]
    assert recv._have - recv._start == len(payloads[-1]) + 4 - 3


@pytest.mark.parametrize("native_split", [True, False])
def test_oversized_frame_closes_the_connection(native_split, monkeypatch):
    if not native_split:
        monkeypatch.setattr(PN, "_native_split_frames", None)
    evil = (PN.MAX_FRAME + 1).to_bytes(4, "little") + b"boom"
    recv, frames = _drain_receiver(evil, [len(evil)])
    assert frames == []
    assert isinstance(recv._exc, SerdeError)
    assert str(recv._exc) == f"frame of {PN.MAX_FRAME + 1} bytes exceeds MAX_FRAME"
    assert recv._transport.closed


def test_connection_send_queue_urgent_lane_and_drops():
    async def main():
        metrics = Metrics()
        conn = PN.Connection(peer=5, metrics=metrics)
        while conn.try_send(PN.Blocks((b"bulk",))):
            pass
        assert conn.sender.full()
        await asyncio.wait_for(conn.send(PN.Ping(7)), timeout=0.5)
        assert isinstance(conn.sender.get_nowait(), PN.Ping)
        counter = metrics.connection_send_drops_total.labels("5")
        base = counter._value.get()
        assert base >= 1 and not conn.try_send(PN.Blocks((b"x",)))
        assert counter._value.get() == base + 1
        accepted = sum(conn.try_send(PN.Pong(i)) for i in range(100))
        assert accepted == PN._SendQueue.URGENT_CAP

    asyncio.run(main())


async def _start_pair(cls0, cls1, metrics0=None, metrics1=None):
    """Two endpoints on 127.0.0.1: authority 1 listens on a free port,
    authority 0 dials it; returns both networks and their connections."""
    addresses = [("127.0.0.1", 0), ("127.0.0.1", 0)]
    net1 = await cls1.start(1, addresses, metrics1)
    addresses[1] = ("127.0.0.1", net1._server.sockets[0].getsockname()[1])
    net0 = await cls0.start(0, addresses, metrics0)
    conn0 = await asyncio.wait_for(net0.connections.get(), 10)
    conn1 = await asyncio.wait_for(net1.connections.get(), 10)
    return net0, net1, conn0, conn1


def _signed_raws(n_blocks, tx_bytes=512, txs=8):
    signers = JCommittee.benchmark_signers(4)
    genesis = [JT.StatementBlock.new_genesis(a).reference for a in range(4)]
    rng = random.Random(0x7E7)
    return [JT.StatementBlock.build(i % 4, 1 + i // 4, genesis,
                                    [JT.Share(rng.randbytes(tx_bytes)) for _ in range(txs)],
                                    signer=signers[i % 4]).to_bytes()
            for i in range(n_blocks)]


async def _exchange(conn_send, conn_recv, messages, n_frames):
    for msg in messages:
        await conn_send.send(msg)
    got = []
    for _ in range(n_frames):
        got.append(await asyncio.wait_for(conn_recv.recv(), 10))
    return got


@pytest.mark.parametrize("zero_copy", [True, False])
def test_loopback_blocks_and_ping_pong_between_port_endpoints(zero_copy, monkeypatch):
    if not zero_copy:
        # A transport that cannot be switched: the read loop stays on the
        # StreamReader and the frames are the same.
        monkeypatch.setattr(PN._FrameReceiver, "attach", classmethod(lambda cls, r, w: None))
    raws = _signed_raws(12)

    async def main():
        m0, m1 = Metrics(), Metrics()
        net0, net1, conn0, conn1 = await _start_pair(PN.TcpNetwork, PN.TcpNetwork, m0, m1)
        try:
            frames = [PN.Blocks(tuple(raws[i: i + 5])) for i in range(0, len(raws), 5)]
            got = await _exchange(conn0, conn1, frames, len(frames))
            assert all(type(m) is PN.Blocks for m in got)
            views = [b for m in got for b in m.blocks]
            assert all(type(v) is (memoryview if zero_copy else bytes) for v in views)
            blocks = PT.StatementBlock.from_bytes_many(views)
            assert [b.to_bytes() for b in blocks] == raws
            assert all(b._signed_digest is not None for b in blocks)
            # And back the other way, answered by the other side's read loop.
            back = await _exchange(conn1, conn0, [PN.Blocks((raws[0],))], 1)
            assert bytes(back[0].blocks[0]) == raws[0]
            # Ping/Pong: each side's read loop echoes the other's probe.
            await conn0.send(PN.Ping(1))
            for _ in range(100):
                if conn0.latency() < float("inf") and conn1.latency() < float("inf"):
                    break
                await asyncio.sleep(0.02)
            assert conn0.latency() < 5.0 and conn1.latency() < 5.0
            wire = sum(len(PN.encode_message(f)) + 4 for f in frames)
            assert m1.mesh_wire_bytes_total.labels("received")._value.get() >= wire
            assert m0.mesh_wire_bytes_total.labels("sent")._value.get() >= wire
        finally:
            await net0.stop()
            await net1.stop()

    asyncio.run(main())


@pytest.mark.parametrize("port_dials", [True, False])
def test_loopback_blocks_between_a_port_and_a_jax_endpoint(port_dials):
    """The handshake and the frames are the JAX package's: a port endpoint
    and a JAX-package endpoint exchange ``Blocks`` both ways."""
    raws = _signed_raws(8)

    async def main():
        cls0, cls1 = (PN.TcpNetwork, JN.TcpNetwork) if port_dials else (JN.TcpNetwork, PN.TcpNetwork)
        net0, net1, conn0, conn1 = await _start_pair(cls0, cls1)
        port_conn, jax_conn = (conn0, conn1) if port_dials else (conn1, conn0)
        try:
            sent = [PN.Blocks(tuple(raws[:4])), PN.Blocks(tuple(raws[4:]))]
            got = await _exchange(port_conn, jax_conn, sent, 2)
            assert all(type(m) is JN.Blocks for m in got)
            assert [bytes(b) for m in got for b in m.blocks] == raws
            back = await _exchange(jax_conn, port_conn, [JN.Blocks(tuple(raws))], 1)
            assert type(back[0]) is PN.Blocks
            blocks = PT.StatementBlock.from_bytes_many(back[0].blocks)
            assert [b.to_bytes() for b in blocks] == raws
        finally:
            await net0.stop()
            await net1.stop()

    asyncio.run(main())


def test_jittered_backoff_stays_in_its_band():
    rng = random.Random(3)
    for _ in range(200):
        assert 0.05 <= PN.jittered_backoff(0.1, rng) < 0.15
