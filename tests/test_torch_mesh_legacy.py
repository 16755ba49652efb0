"""``MYSTICETI_MESH_LEGACY=1`` in the port, against the JAX package.

Under the knob the port runs the pre-broadcast-once data plane as the JAX
package does: ``_FrameReceiver.attach`` refuses (stream receive), the write
loop encodes and drains frame by frame (no coalescing, no wire-byte
counters) and ``NetworkSyncer`` builds no shared ``FrameCache``.  The frames
stay the golden corpus's bytes: a legacy exchange between two port
endpoints, and between a port and a JAX-package endpoint, carries the same
frames as the default path.
"""
import asyncio
import tempfile

import pytest

import mysticeti_tpu.network as JN
import mysticeti_tpu_torch.network as PN
from mysticeti_tpu_torch.metrics import Metrics

from test_mesh_data_plane import GOLDEN_CORPUS, _socket_pair
from test_torch_net_sync import build_node
from test_torch_network import _exchange, _start_pair, _to_port

# Ping and Pong are answered by the read loop and never surface.
CARRIED = [(m, h) for m, h in GOLDEN_CORPUS if not isinstance(m, (JN.Ping, JN.Pong))]


def _legacy(monkeypatch, on):
    if on:
        monkeypatch.setenv("MYSTICETI_MESH_LEGACY", "1")
    else:
        monkeypatch.delenv("MYSTICETI_MESH_LEGACY", raising=False)


def test_legacy_env_disables_new_plane(monkeypatch):
    """The port's counterpart of ``tests/test_mesh_data_plane.py::
    test_legacy_env_disables_new_plane``, read per call like the JAX
    package's."""
    monkeypatch.setenv("MYSTICETI_MESH_LEGACY", "1")
    assert PN.mesh_legacy() and JN.mesh_legacy()

    async def main():
        server, c_reader, c_writer, s_reader, s_writer = await _socket_pair()
        assert PN._FrameReceiver.attach(s_reader, s_writer) is None
        s_writer.close()
        c_writer.close()
        server.close()

    asyncio.run(main())
    monkeypatch.delenv("MYSTICETI_MESH_LEGACY")
    assert not PN.mesh_legacy() and not JN.mesh_legacy()

    async def attached():
        server, c_reader, c_writer, s_reader, s_writer = await _socket_pair()
        assert PN._FrameReceiver.attach(s_reader, s_writer) is not None
        s_writer.close()
        c_writer.close()
        server.close()

    asyncio.run(attached())


def test_attach_counts_the_connections_it_switches(monkeypatch):
    """``_FrameReceiver.attached`` counts the connections switched to
    zero-copy reads: both ends of a port pair on the default path, none
    under the knob (what ``mesh_ab`` reports as ``receivers_attached``)."""
    for legacy, switched in ((True, 0), (False, 2)):
        before = PN._FrameReceiver.attached
        _port_frames(monkeypatch, legacy)
        assert PN._FrameReceiver.attached - before == switched


def _port_frames(monkeypatch, legacy):
    """The golden corpus's carried messages sent from one port endpoint to
    another, each way; returns the received frames' bytes, each way, and
    the sender's and receiver's metrics."""
    _legacy(monkeypatch, legacy)
    messages = [_to_port(m) for m, _ in CARRIED]

    async def main():
        m0, m1 = Metrics(), Metrics()
        net0, net1, conn0, conn1 = await _start_pair(PN.TcpNetwork, PN.TcpNetwork, m0, m1)
        try:
            there = await _exchange(conn0, conn1, messages, len(messages))
            back = await _exchange(conn1, conn0, messages, len(messages))
        finally:
            await net0.stop()
            await net1.stop()
        return ([PN.encode_message(m).hex() for m in there],
                [PN.encode_message(m).hex() for m in back], m0, m1)

    return asyncio.run(main())


def test_legacy_loopback_between_port_endpoints_carries_the_default_frames(monkeypatch):
    legacy_there, legacy_back, l0, l1 = _port_frames(monkeypatch, True)
    default_there, default_back, d0, d1 = _port_frames(monkeypatch, False)
    expected = [h for _, h in CARRIED]
    assert legacy_there == legacy_back == default_there == default_back == expected
    for m in (l0, l1):
        # The legacy path predates the wire counters and never coalesces,
        # but keeps the encode timer the A/B reads.
        assert m.mesh_wire_bytes_total.labels("sent")._value.get() == 0
        assert m.mesh_wire_bytes_total.labels("received")._value.get() == 0
        assert m.mesh_frames_coalesced_total._value.get() == 0
        assert m.utilization_timer_us.labels("net:mesh_encode")._value.get() > 0
    wire = sum(len(bytes.fromhex(h)) + 4 for h in expected)
    assert d0.mesh_wire_bytes_total.labels("sent")._value.get() >= wire
    assert d1.mesh_wire_bytes_total.labels("received")._value.get() >= wire


@pytest.mark.parametrize("port_dials", [True, False])
def test_legacy_loopback_between_a_port_and_a_jax_endpoint(port_dials, monkeypatch):
    """Both endpoints under the knob: the JAX package's legacy plane and the
    port's exchange the corpus's frames both ways, byte for byte."""
    _legacy(monkeypatch, True)
    expected = [h for _, h in CARRIED]

    async def main():
        cls0, cls1 = (PN.TcpNetwork, JN.TcpNetwork) if port_dials else (JN.TcpNetwork, PN.TcpNetwork)
        net0, net1, conn0, conn1 = await _start_pair(cls0, cls1)
        port_conn, jax_conn = (conn0, conn1) if port_dials else (conn1, conn0)
        try:
            got = await _exchange(port_conn, jax_conn, [_to_port(m) for m, _ in CARRIED],
                                  len(CARRIED))
            assert [JN.encode_message(m).hex() for m in got] == expected
            back = await _exchange(jax_conn, port_conn, [m for m, _ in CARRIED], len(CARRIED))
            assert [type(m).__module__ for m in back] == ["mysticeti_tpu_torch.network"] * len(back)
            assert [PN.encode_message(m).hex() for m in back] == expected
        finally:
            await net0.stop()
            await net1.stop()

    asyncio.run(main())


@pytest.mark.parametrize("legacy", [True, False])
def test_network_syncer_frame_cache_follows_the_knob(legacy, monkeypatch):
    """``NetworkSyncer.frame_cache`` is None under the knob in both
    packages, a ``FrameCache`` otherwise."""
    _legacy(monkeypatch, legacy)
    caches = {}
    for pkg in ("mysticeti_tpu", "mysticeti_tpu_torch"):
        committee_mod = __import__(f"{pkg}.committee", fromlist=["Committee"])
        config = __import__(f"{pkg}.config", fromlist=["Parameters"])
        simulated = __import__(f"{pkg}.simulated_network", fromlist=["SimulatedNetwork"])
        committee = committee_mod.Committee.new_test([1] * 4)
        signers = committee_mod.Committee.benchmark_signers(4)
        with tempfile.TemporaryDirectory() as tmp:
            node = build_node(pkg, committee, signers, 0, tmp, simulated.SimulatedNetwork(4),
                              config.Parameters())
            caches[pkg] = node.frame_cache
    if legacy:
        assert caches == {"mysticeti_tpu": None, "mysticeti_tpu_torch": None}
    else:
        assert [type(c).__name__ for c in caches.values()] == ["FrameCache", "FrameCache"]
