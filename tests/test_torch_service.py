"""The port's shared verifier service against the JAX package's.

The port's counterparts of ``tests/test_verifier_service.py``: the unix-
socket protocol driven end to end with an injected CPU-oracle backend, the
warmup gate, the committee rules, reconnects, the staged client, the hybrid
router's pin on a CPU-only service, the wire buffers and the socket's trust
checks.  Where the client matters, both packages' ``RemoteSignatureVerifier``
talk to the port's ``VerifierServer``.  The wire is held to the JAX
package's byte for byte, and the port's ``TorchSignatureVerifier`` on the
CPU serves both clients with the verdicts it gives in process.
"""
import asyncio
import os
import struct

import pytest

from mysticeti_tpu import verifier_service as JVS
from mysticeti_tpu_torch import crypto
from mysticeti_tpu_torch import verifier_service as PVS
from mysticeti_tpu_torch.block_validator import (
    CpuSignatureVerifier,
    SignatureVerifier,
    TorchSignatureVerifier,
)
from mysticeti_tpu_torch.verifier_service import RemoteSignatureVerifier, VerifierServer

CLIENTS = {"port": PVS.RemoteSignatureVerifier, "jax": JVS.RemoteSignatureVerifier}


class CountingBackend(SignatureVerifier):
    """CPU oracle + call accounting, to observe dispatch/warmup behavior."""

    def __init__(self) -> None:
        self.inner = CpuSignatureVerifier()
        self.warmups = 0
        self.calls = 0

    def warmup(self) -> None:
        self.warmups += 1

    def verify_signatures(self, public_keys, digests, signatures):
        self.calls += 1
        return self.inner.verify_signatures(public_keys, digests, signatures)


def _sigs(n, signers):
    pks, digests, sigs = [], [], []
    for i in range(n):
        signer = signers[i % len(signers)]
        digest = crypto.blake2b_256(b"payload-%d" % i)
        pks.append(signer.public_key.bytes)
        digests.append(digest)
        sigs.append(signer.sign(digest))
    return pks, digests, sigs


@pytest.fixture()
def signers():
    return [crypto.Signer.from_seed(i.to_bytes(32, "little")) for i in range(4)]


async def _with_server(tmp_path, committee_keys, backend, fn):
    server = VerifierServer(
        str(tmp_path / "verifier.sock"),
        committee_keys=committee_keys,
        backend=backend,
    )
    await server.start()
    try:
        return await fn(server)
    finally:
        await server.stop()


def test_wire_constants_and_frames_equal_the_jax_package(signers):
    """Frame types, record sizes and every frame a client builds (HELLO,
    indexed VERIFY, RAW) equal the JAX package's byte for byte."""
    for name in ("T_HELLO", "T_VERIFY", "T_RAW", "T_HELLO_OK", "T_RESULT", "T_ERR",
                 "_IDX_REC", "_RAW_REC", "ENV_SOCKET"):
        assert getattr(PVS, name) == getattr(JVS, name), name
    keys = [s.public_key.bytes for s in signers]
    hello = struct.pack("<H", len(keys)) + b"".join(keys)
    assert PVS._frame(PVS.T_HELLO, hello) == JVS._frame(JVS.T_HELLO, hello)
    assert PVS._frame(PVS.T_ERR, b"x") == JVS._frame(JVS.T_ERR, b"x")
    stranger = crypto.Signer.from_seed(b"\x31" * 32)
    pks, digests, sigs = _sigs(6, signers)
    cases = [(pks, digests, sigs),
             ([stranger.public_key.bytes] + pks[1:], digests, sigs)]  # RAW
    for req_id, (p, d, s) in enumerate(cases, start=7):
        port = PVS.RemoteSignatureVerifier(socket_path="/nonexistent", committee_keys=keys)
        jax = JVS.RemoteSignatureVerifier(socket_path="/nonexistent", committee_keys=keys)
        got = bytes(port._pack_request(p, d, s, req_id, len(s)))
        want = bytes(jax._pack_request(p, d, s, req_id, len(s)))
        assert got == want
        assert got[4] == (PVS.T_VERIFY if req_id == 7 else PVS.T_RAW)
    # Non-digest messages never ride the wire, in either package.
    assert port._pack_request(pks[:1], [b"short"], sigs[:1], 1, 1) is None


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_roundtrip_indexed_and_raw(tmp_path, signers, client):
    keys = [s.public_key.bytes for s in signers]
    backend = CountingBackend()

    async def scenario(server):
        remote = CLIENTS[client](socket_path=server.socket_path, committee_keys=keys)
        await asyncio.to_thread(remote.warmup)
        base = backend.calls  # warmup + server-side calibration dispatches
        # The service measured its own dispatch costs and shared them.
        assert remote.dispatch_calibration() is not None
        pks, digests, sigs = _sigs(8, signers)
        # Corrupt one signature: result order must be preserved.
        sigs[3] = bytes(64)
        ok = await asyncio.to_thread(remote.verify_signatures, pks, digests, sigs)
        assert ok == [True, True, True, False, True, True, True, True]
        # A pk OUTSIDE the committee routes through the RAW frame.
        stranger = crypto.Signer.from_seed(b"\x99" * 32)
        digest = crypto.blake2b_256(b"raw")
        ok = await asyncio.to_thread(
            remote.verify_signatures,
            [stranger.public_key.bytes], [digest], [stranger.sign(digest)],
        )
        assert ok == [True]
        assert backend.calls == base + 2

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))


def test_hello_is_the_warmup_gate_and_runs_once(tmp_path, signers):
    keys = [s.public_key.bytes for s in signers]
    backend = CountingBackend()

    async def scenario(server):
        clients = [
            RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
            for _ in range(3)
        ]
        # Concurrent warmups (a booting fleet): exactly one backend warmup.
        await asyncio.gather(*(asyncio.to_thread(c.warmup) for c in clients))
        assert backend.warmups == 1

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_committee_mismatch_rejected(tmp_path, signers, client):
    keys = [s.public_key.bytes for s in signers]

    async def scenario(server):
        other = crypto.Signer.from_seed(b"\x42" * 32)
        remote = CLIENTS[client](
            socket_path=server.socket_path, committee_keys=[other.public_key.bytes],
        )
        with pytest.raises(ConnectionError, match="committee mismatch"):
            await asyncio.to_thread(remote.warmup)

    asyncio.run(_with_server(tmp_path, keys, CountingBackend(), scenario))


def test_client_reconnects_after_service_restart(tmp_path, signers):
    """The service restarting severs every cached client connection; the
    next call must transparently reconnect.  A 1-thread executor pins the
    client to ONE os thread so its thread-local connection is reused."""
    from concurrent.futures import ThreadPoolExecutor

    keys = [s.public_key.bytes for s in signers]

    async def main():
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=1)
        client = RemoteSignatureVerifier(
            socket_path=str(tmp_path / "verifier.sock"), committee_keys=keys
        )
        pks, digests, sigs = _sigs(2, signers)

        def call():
            return client.verify_signatures(pks, digests, sigs)

        server1 = VerifierServer(client.socket_path, committee_keys=keys, backend=CountingBackend())
        await server1.start()
        assert await loop.run_in_executor(pool, call) == [True, True]
        await server1.stop()
        server2 = VerifierServer(client.socket_path, committee_keys=keys, backend=CountingBackend())
        await server2.start()
        try:
            assert await loop.run_in_executor(pool, call) == [True, True]
        finally:
            await server2.stop()
            pool.shutdown(wait=False)

    asyncio.run(main())


def test_concurrent_clients_share_one_backend(tmp_path, signers):
    keys = [s.public_key.bytes for s in signers]
    backend = CountingBackend()

    async def scenario(server):
        async def one_validator(seed):
            client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
            pks, digests, sigs = _sigs(16, signers)
            return await asyncio.to_thread(client.verify_signatures, pks, digests, sigs)

        results = await asyncio.gather(*(one_validator(i) for i in range(4)))
        assert all(all(r) for r in results)
        # 4 verify dispatches on top of warmup + server-side calibration.
        assert backend.calls == 2 + 4

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))


def test_service_telemetry_queue_and_inflight_gauges(tmp_path, signers):
    """With metrics wired, the service tracks queue depth and per-connection
    in-flight requests (back to zero once answered) plus dispatch shape and
    padding series; the client counts its wire bytes."""
    from mysticeti_tpu_torch.metrics import Metrics

    keys = [s.public_key.bytes for s in signers]
    metrics, client_metrics = Metrics(), Metrics()

    async def scenario():
        server = VerifierServer(
            str(tmp_path / "verifier.sock"), committee_keys=keys,
            backend=CountingBackend(), metrics=metrics,
        )
        await server.start()
        try:
            client = RemoteSignatureVerifier(
                socket_path=server.socket_path, committee_keys=keys, metrics=client_metrics
            )
            pks, digests, sigs = _sigs(8, signers)
            assert all(await asyncio.to_thread(client.verify_signatures, pks, digests, sigs))
        finally:
            await server.stop()

    asyncio.run(scenario())
    assert metrics.verifier_service_queue_depth._value.get() == 0
    scrape = metrics.expose().decode()
    # The per-connection in-flight child is REMOVED once the connection
    # closes: reconnecting fleets must not grow dead labeled series forever.
    assert 'verifier_service_inflight{connection="c0"}' not in scrape
    assert "verify_dispatch_batch_size_count 1.0" in scrape
    assert 'verify_padding_wasted_total{backend="service"} 0.0' in scrape
    wire = client_metrics.verify_wire_bytes_total
    hello = 5 + 2 + 32 * len(keys)
    assert wire.labels("sent")._value.get() == hello + 13 + 8 * PVS._IDX_REC
    # HELLO_OK (16-byte calibration + "cpu") and the 8 verdicts.
    assert wire.labels("recv")._value.get() == (5 + 16 + 3) + (5 + 4 + 8)


@pytest.mark.parametrize("kind", ["cuda", "cuda-only"])
def test_make_verifier_uses_service_when_env_set(tmp_path, monkeypatch, kind):
    """``_make_verifier`` routes both accelerator kinds through the service
    when ``MYSTICETI_VERIFIER_SOCKET`` is set (no in-process backend, so no
    card is needed), with ``metrics`` reaching the client and the router."""
    from mysticeti_tpu_torch.block_validator import HybridSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.validator import _make_verifier

    committee = Committee.new_for_benchmarks(4)
    keys = committee.public_key_bytes()
    backend = CountingBackend()
    metrics = Metrics()

    async def scenario(server):
        monkeypatch.setenv("MYSTICETI_VERIFIER_SOCKET", server.socket_path)
        verifier = _make_verifier(kind, committee, metrics=metrics)
        # ready is set by a warmup thread whose HELLO needs THIS event loop.
        assert await asyncio.to_thread(verifier.ready.wait, 30)
        remote = verifier.verifier
        if kind == "cuda":
            assert isinstance(remote, HybridSignatureVerifier)
            assert remote.metrics is metrics
            remote = remote.tpu
        assert isinstance(remote, RemoteSignatureVerifier)
        assert remote.metrics is metrics and verifier.metrics is metrics
        assert remote.advertised_backend == "cpu"  # CountingBackend: a host oracle

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))
    assert metrics.verify_wire_bytes_total.labels("sent")._value.get() > 0


def test_service_with_the_port_backend(tmp_path, signers):
    """The whole stack on the port's own backend (``TorchSignatureVerifier``
    on the CPU: the kernels' plain versions): both packages' clients get the
    verdicts the same backend gives in process, indexed and RAW, and HELLO_OK
    advertises the torch device."""
    keys = [s.public_key.bytes for s in signers]
    pks, digests, sigs = _sigs(6, signers)
    sigs[4] = bytes(64)
    indexed = (pks, digests, sigs)
    stranger = crypto.Signer.from_seed(b"\x13" * 32)
    raw = ([stranger.public_key.bytes] + pks[1:], digests,
           [stranger.sign(digests[0])] + sigs[1:3] + [sigs[2]] + sigs[4:])  # a wrong sig at 3
    batches = {"indexed": indexed, "raw": raw}

    async def scenario(server):
        out = {}
        for name, cls in sorted(CLIENTS.items()):
            remote = cls(socket_path=server.socket_path, committee_keys=keys)
            await asyncio.to_thread(remote.warmup)
            assert remote.advertised_backend == "cpu"
            assert remote.dispatch_calibration() is not None
            for batch, args in batches.items():
                out[name, batch] = await asyncio.to_thread(remote.verify_signatures, *args)
        in_process = {}
        for batch, args in batches.items():
            got = await asyncio.to_thread(server._backend.verify_signatures, *args)
            in_process[batch] = [bool(x) for x in got]
        return out, in_process

    backend = TorchSignatureVerifier(mesh=None, committee_keys=keys, device="cpu")
    out, in_process = asyncio.run(_with_server(tmp_path, keys, backend, scenario))
    assert in_process == {"indexed": [True, True, True, True, False, True],
                          "raw": [True, True, True, False, False, True]}
    for (client, batch), got in out.items():
        assert got == in_process[batch], (client, batch)


def test_service_backend_on_cuda_raises_without_a_card(tmp_path, signers):
    """The default backend runs on ``cuda``: with no card it raises, never
    serving from the CPU unasked."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default backend builds")
    server = VerifierServer(str(tmp_path / "verifier.sock"),
                            committee_keys=[s.public_key.bytes for s in signers])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.prewarm()


def test_empty_hello_does_not_poison_the_committee(tmp_path, signers):
    """A first HELLO with ZERO keys (a RAW-only client) must not be adopted
    as the service committee: later clients presenting the real committee
    would get a permanent 'committee mismatch' ERR."""
    keys = [s.public_key.bytes for s in signers]

    async def scenario(server):
        keyless = RemoteSignatureVerifier(socket_path=server.socket_path)
        await asyncio.to_thread(keyless.warmup)  # HELLO with 0 keys
        # RAW verifies work for the keyless client...
        stranger = crypto.Signer.from_seed(b"\x77" * 32)
        digest = crypto.blake2b_256(b"raw-only")
        ok = await asyncio.to_thread(
            keyless.verify_signatures,
            [stranger.public_key.bytes], [digest], [stranger.sign(digest)],
        )
        assert ok == [True]
        # ...and the first REAL committee still establishes the key set.
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        await asyncio.to_thread(client.warmup)
        pks, digests, sigs = _sigs(4, signers)
        ok = await asyncio.to_thread(client.verify_signatures, pks, digests, sigs)
        assert ok == [True] * 4

    asyncio.run(_with_server(tmp_path, None, CountingBackend(), scenario))


def test_server_pipelines_requests_on_one_connection(tmp_path, signers):
    """The service reads/decodes request N+1 while N computes: two
    back-to-back requests on ONE connection against a slow backend complete
    in about one compute time, not two, and replies come back in order."""
    import time as _time

    delay = 0.3
    keys = [s.public_key.bytes for s in signers]

    class SlowBackend(CountingBackend):
        def verify_signatures(self, public_keys, digests, signatures):
            _time.sleep(delay)
            return super().verify_signatures(public_keys, digests, signatures)

    async def scenario(server):
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        pks, digests, sigs = _sigs(2, signers)
        body = b"".join(pk + d + s for pk, d, s in zip(pks, digests, sigs))

        def pipelined():
            conn = client._connect()
            try:
                for req_id in (1, 2):
                    conn.sendall(PVS._frame(PVS.T_RAW, struct.pack("<II", req_id, 2) + body))
                started = _time.monotonic()
                out = []
                for _ in (1, 2):
                    type_, payload = client._read_frame(conn)
                    (echoed,) = struct.unpack_from("<I", payload)
                    out.append((type_, echoed, list(payload[4:])))
                return _time.monotonic() - started, out
            finally:
                conn.close()

        elapsed, replies = await asyncio.to_thread(pipelined)
        assert [r[1] for r in replies] == [1, 2]  # in request order
        assert all(r[2] == [1, 1] for r in replies)
        # Overlapped: well under 2 x the per-request compute.
        assert elapsed < 2 * delay * 0.9, elapsed

    asyncio.run(_with_server(tmp_path, keys, SlowBackend(), scenario))


def test_client_async_dispatch_overlaps_and_survives_restart(tmp_path, signers):
    """verify_signatures_async sends now and reads at result(): two
    in-flight requests overlap through the service, and a service restart
    between submit and fetch re-runs the batch through the sync retry path
    instead of losing it."""
    import time as _time

    delay = 0.3
    keys = [s.public_key.bytes for s in signers]

    class SlowBackend(CountingBackend):
        def verify_signatures(self, public_keys, digests, signatures):
            _time.sleep(delay)
            return super().verify_signatures(public_keys, digests, signatures)

    async def main():
        server = VerifierServer(str(tmp_path / "verifier.sock"), committee_keys=keys,
                                backend=SlowBackend())
        await server.start()
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        pks, digests, sigs = _sigs(4, signers)

        def overlapped():
            # Warmup, calibration and pool connects OUTSIDE the timed region.
            w1 = client.verify_signatures_async(pks, digests, sigs)
            w2 = client.verify_signatures_async(pks, digests, sigs)
            w1.result(), w2.result()
            started = _time.monotonic()
            h1 = client.verify_signatures_async(pks, digests, sigs)
            h2 = client.verify_signatures_async(pks, digests, sigs)
            out = (h1.result(), h2.result())
            return _time.monotonic() - started, out

        try:
            elapsed, (r1, r2) = await asyncio.to_thread(overlapped)
            assert r1 == [True] * 4 and r2 == [True] * 4
            assert elapsed < 2 * delay * 0.9, elapsed
            # Submit, then kill and restart the service before fetching.
            handle = await asyncio.to_thread(client.verify_signatures_async, pks, digests, sigs)
        finally:
            await server.stop()
        server2 = VerifierServer(str(tmp_path / "verifier.sock"), committee_keys=keys,
                                 backend=CountingBackend())
        await server2.start()
        try:
            assert await asyncio.to_thread(handle.result) == [True] * 4
        finally:
            await server2.stop()

    asyncio.run(main())


def test_cpu_advertising_service_short_circuits(tmp_path, signers):
    """Against a service advertising a CPU-only backend, the hybrid router
    pins routing to the in-process oracle: batches complete with ZERO socket
    frames and verify_shortcircuit_total flips."""
    from mysticeti_tpu_torch.block_validator import HybridSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics

    keys = [s.public_key.bytes for s in signers]
    backend = CountingBackend()
    metrics = Metrics()

    async def scenario(server):
        remote = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        hybrid = HybridSignatureVerifier(tpu=remote, metrics=metrics)
        # Frozen clock: the re-HELLO upgrade probe's deadline never passes.
        hybrid._breaker_clock = lambda: 0.0
        await asyncio.to_thread(hybrid.warmup)
        assert remote.advertised_backend == "cpu"
        assert hybrid.pinned_backend == "cpu"
        assert hybrid.threshold() == hybrid.NEVER
        base_calls = backend.calls

        def socket_is_lava(*_a, **_k):
            raise AssertionError("pinned batch touched the service socket")

        remote.verify_signatures = socket_is_lava
        remote.verify_signatures_async = socket_is_lava
        # Well above DEFAULT_THRESHOLD: unpinned, this WOULD offload.
        pks, digests, sigs = _sigs(40, signers)
        sigs[5] = bytes(64)
        expected = [True] * 5 + [False] + [True] * 34

        def run_batch():
            ok = hybrid.verify_signatures(pks, digests, sigs)
            return ok, hybrid.backend_label

        for _ in range(2):
            ok, label = await asyncio.to_thread(run_batch)
            assert ok == expected
            assert label == "hybrid-cpu"
        assert backend.calls == base_calls  # zero frames reached the service
        assert metrics.verify_shortcircuit_total.labels("backend-cpu")._value.get() == 2

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))


def test_backend_upgrade_reopens_offload_without_restart(tmp_path, signers):
    """When the service re-advertises an accelerator backend, the pinned
    hybrid's re-HELLO probe unpins routing and offload resumes — no
    validator restart."""
    from mysticeti_tpu_torch.block_validator import HybridSignatureVerifier

    keys = [s.public_key.bytes for s in signers]

    class SwitchableBackend(CountingBackend):
        platform = "cpu"

        def resolved_backend(self):
            return self.platform

    backend = SwitchableBackend()

    async def scenario(server):
        remote = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        clock = {"t": 0.0}
        hybrid = HybridSignatureVerifier(tpu=remote, threshold=1)
        hybrid._breaker_clock = lambda: clock["t"]
        await asyncio.to_thread(hybrid.warmup)
        assert hybrid.pinned_backend == "cpu"
        base = backend.calls
        pks, digests, sigs = _sigs(4, signers)
        # Pinned: the batch stays on the oracle (no service dispatch).
        ok = await asyncio.to_thread(hybrid.verify_signatures, pks, digests, sigs)
        assert ok == [True] * 4 and backend.calls == base
        # The card arrives: the service now resolves to an accelerator.
        backend.platform = "cuda"
        clock["t"] = 60.0  # past any jittered probe deadline
        # This batch carries the re-HELLO probe (still verified on the
        # oracle — the probe is a HELLO frame, never a verify).
        ok = await asyncio.to_thread(hybrid.verify_signatures, pks, digests, sigs)
        assert ok == [True] * 4 and backend.calls == base
        assert remote.advertised_backend == "cuda"
        assert hybrid.pinned_backend is None
        # Offload is open again: the next batch rides the socket.
        ok = await asyncio.to_thread(hybrid.verify_signatures, pks, digests, sigs)
        assert ok == [True] * 4
        assert backend.calls == base + 1

    asyncio.run(_with_server(tmp_path, keys, backend, scenario))


class AuditBuf(bytearray):
    """bytearray that counts slice-assignments — each one is exactly one
    copy of payload bytes into the wire buffer."""

    def __init__(self, *args):
        super().__init__(*args)
        self.writes = 0

    def __setitem__(self, key, value):
        self.writes += 1
        super().__setitem__(key, value)


class ScriptedSock:
    """In-memory service endpoint: records what sendall receives (object
    identity included) and answers each VERIFY/RAW with an all-valid RESULT
    via recv_into."""

    def __init__(self):
        self.sent = []
        self.recv_targets = []
        self._rx = bytearray()

    def sendall(self, data):
        assert isinstance(data, memoryview), type(data)
        self.sent.append((data.obj, len(data)))
        length, type_, req_id, n = struct.unpack_from("<IBII", data)
        payload = struct.pack("<I", req_id) + b"\x01" * n
        self._rx += struct.pack("<IB", len(payload), PVS.T_RESULT) + payload

    def recv_into(self, view):
        assert isinstance(view, memoryview)
        self.recv_targets.append(view.obj)
        n = min(len(view), len(self._rx))
        view[:n] = self._rx[:n]
        del self._rx[:n]
        return n

    def close(self):
        pass


def test_pack_path_copies_once_and_reuses_buffer(signers):
    """The pack path copies each digest/signature (and key, on the RAW
    path) once, sends straight from the per-connection buffer, and reuses
    that buffer across dispatches with zero reallocation."""
    keys = [s.public_key.bytes for s in signers]
    client = RemoteSignatureVerifier(socket_path="/nonexistent.sock", committee_keys=keys)
    sock = ScriptedSock()
    client._tls.conn = sock  # bypass connect/HELLO: unit-level wire audit
    client._tls.req_id = 0
    pack = client._wire("pack")
    audit = AuditBuf(len(pack.buf))
    pack.buf = audit

    pks, digests, sigs = _sigs(8, signers)
    for _ in range(12):
        before = audit.writes
        assert client.verify_signatures(pks, digests, sigs) == [True] * 8
        assert audit.writes - before == 2 * len(sigs)
    assert {id(obj) for obj, _ in sock.sent} == {id(audit)}
    assert pack.buf is audit and pack.grows == 0, "buffer was reallocated"
    assert {id(obj) for obj in sock.recv_targets} == {id(client._wire("recv").buf)}

    stranger = crypto.Signer.from_seed(b"\x55" * 32)
    digest = crypto.blake2b_256(b"raw-audit")
    before = audit.writes
    ok = client.verify_signatures(
        [stranger.public_key.bytes] * 4, [digest] * 4, [stranger.sign(digest)] * 4,
    )
    assert ok == [True] * 4
    assert audit.writes - before == 3 * 4


def test_hello_ok_version_skew_old_client(tmp_path, signers):
    """An old-protocol client (parses HELLO_OK only when exactly 16 bytes)
    still interoperates: it loses the calibration but VERIFY/RESULT work."""
    keys = [s.public_key.bytes for s in signers]

    async def scenario(server):
        pks, digests, sigs = _sigs(3, signers)
        body = b"".join(struct.pack("<H", keys.index(pk)) + d + s
                        for pk, d, s in zip(pks, digests, sigs))

        def old_client():
            import socket as _socket

            conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            conn.settimeout(30)
            conn.connect(server.socket_path)

            def read_frame():
                header = b""
                while len(header) < 5:
                    header += conn.recv(5 - len(header))
                length, type_ = struct.unpack("<IB", header)
                payload = b""
                while len(payload) < length:
                    payload += conn.recv(length - len(payload))
                return type_, payload

            try:
                hello = struct.pack("<H", len(keys)) + b"".join(keys)
                conn.sendall(PVS._frame(PVS.T_HELLO, hello))
                t1, reply = read_frame()
                calibration = struct.unpack("<dd", reply) if len(reply) == 16 else None
                conn.sendall(PVS._frame(PVS.T_VERIFY, struct.pack("<II", 5, 3) + body))
                t2, payload = read_frame()
                return t1, len(reply), calibration, t2, list(payload[4:])
            finally:
                conn.close()

        t1, reply_len, calibration, t2, oks = await asyncio.to_thread(old_client)
        assert t1 == PVS.T_HELLO_OK and t2 == PVS.T_RESULT
        assert reply_len > 16  # the backend suffix is present...
        assert calibration is None  # ...and the old client ignores it
        assert oks == [1, 1, 1]

    asyncio.run(_with_server(tmp_path, keys, CountingBackend(), scenario))


def test_hello_ok_version_skew_old_server(tmp_path, signers, monkeypatch):
    """A new client against an old server (16-byte HELLO_OK, no backend
    suffix): calibration still seeds, the backend stays UNKNOWN, so the
    hybrid never pins."""
    keys = [s.public_key.bytes for s in signers]
    monkeypatch.setattr(VerifierServer, "_resolved_backend", lambda self: "")

    async def scenario(server):
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        await asyncio.to_thread(client.warmup)
        assert client.dispatch_calibration() is not None
        assert client.advertised_backend is None
        pks, digests, sigs = _sigs(4, signers)
        ok = await asyncio.to_thread(client.verify_signatures, pks, digests, sigs)
        assert ok == [True] * 4

    asyncio.run(_with_server(tmp_path, keys, CountingBackend(), scenario))


def test_foreign_uid_peer_refused(tmp_path, signers, monkeypatch):
    """A connection from another local user is severed at accept
    (SO_PEERCRED) before any frame is processed."""
    keys = [s.public_key.bytes for s in signers]
    monkeypatch.setattr(PVS, "_peer_uid", lambda sock: os.getuid() + 1)

    async def scenario(server):
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        with pytest.raises((ConnectionError, OSError)):
            await asyncio.to_thread(client.warmup)

    asyncio.run(_with_server(tmp_path, keys, CountingBackend(), scenario))


def test_socket_dir_hardening(tmp_path, signers, monkeypatch):
    """The service refuses to bind into a directory another uid owns, and
    tightens an owned-but-loose parent to 0700 (+ the socket to 0600)."""
    import stat as stat_mod

    keys = [s.public_key.bytes for s in signers]

    async def refused():
        server = VerifierServer(str(tmp_path / "unowned" / "verifier.sock"),
                                committee_keys=keys, backend=CountingBackend())
        (tmp_path / "unowned").mkdir()
        monkeypatch.setattr(os, "getuid", lambda: 0x5EED)
        with pytest.raises(PermissionError, match="owned by uid"):
            await server.start()

    asyncio.run(refused())
    monkeypatch.undo()

    async def tightened():
        sock_dir = tmp_path / "loose"
        sock_dir.mkdir()
        os.chmod(sock_dir, 0o755)
        server = VerifierServer(str(sock_dir / "verifier.sock"), committee_keys=keys,
                                backend=CountingBackend())
        await server.start()
        try:
            assert stat_mod.S_IMODE(os.stat(sock_dir).st_mode) == 0o700
            assert stat_mod.S_IMODE(os.stat(server.socket_path).st_mode) == 0o600
        finally:
            await server.stop()

    asyncio.run(tightened())


def test_pipelined_hello_then_verify_waits_for_committee(tmp_path, signers):
    """A client that pipelines HELLO + VERIFY without waiting for HELLO_OK
    still gets correct verdicts: the verify may not EXECUTE before the HELLO
    that establishes the committee finishes."""
    keys = [s.public_key.bytes for s in signers]

    async def scenario(server):
        client = RemoteSignatureVerifier(socket_path=server.socket_path, committee_keys=keys)
        pks, digests, sigs = _sigs(3, signers)
        body = b"".join(struct.pack("<H", keys.index(pk)) + d + s
                        for pk, d, s in zip(pks, digests, sigs))

        def pipelined():
            import socket as _socket

            conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            conn.settimeout(30)
            conn.connect(server.socket_path)
            try:
                hello = struct.pack("<H", len(keys)) + b"".join(keys)
                conn.sendall(PVS._frame(PVS.T_HELLO, hello)
                             + PVS._frame(PVS.T_VERIFY, struct.pack("<II", 9, 3) + body))
                t1, _ = client._read_frame(conn)
                t2, payload = client._read_frame(conn)
                return t1, t2, list(payload[4:])
            finally:
                conn.close()

        t1, t2, oks = await asyncio.to_thread(pipelined)
        assert t1 == PVS.T_HELLO_OK and t2 == PVS.T_RESULT
        assert oks == [1, 1, 1], oks  # NOT all-zeros

    asyncio.run(_with_server(tmp_path, None, CountingBackend(), scenario))


def test_service_cli_hands_its_arguments_to_run_service(tmp_path, monkeypatch):
    """``python -m mysticeti_tpu_torch.verifier_service`` hands the socket,
    the benchmark committee's keys, the metrics port and the device to
    ``run_service``."""
    from mysticeti_tpu_torch.committee import Committee

    seen = {}
    monkeypatch.setattr(PVS, "run_service",
                        lambda *a, **k: seen.update(args=a, kwargs=k))
    sock = str(tmp_path / "v.sock")
    assert PVS.main(["--socket", sock, "--committee-size", "4", "--device", "cpu"]) == 0
    assert seen["args"] == (sock, Committee.new_for_benchmarks(4).public_key_bytes())
    assert seen["kwargs"] == {"metrics_port": None, "device": "cpu"}
