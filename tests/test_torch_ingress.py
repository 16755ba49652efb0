"""The port's ingress plane (``ingress.py``, ``transactions_generator.py``)
against the JAX package's.

The port's counterparts of 20 of ``tests/test_ingress.py``'s 23 tests (the
mempool's caps, dedup, lane eviction and weighted round robin, the AIMD
admission controller, the plane's accounting, status and shed-mode
transitions, the block handler's soft-cap and dedup counters, the gateway's
wire tags and a live gateway on loopback, the closed-loop generator, the
overload schedule and the parameters' YAML) and of the four ingress tests of
``tests/test_execution.py`` (typed pre-consensus sheds, identity lanes,
notifications deferred until executed, the gateway's EXECUTED resume).  The
health probe's test waits for the port's ``health`` module, the two overload
simulations for its chaos tier.  Each case runs on both packages, holds each
to the reference's assertions and requires the two to give the same values:
shed logs and their digests, lane stats, drain order, frames, generator
batches and stats, with tolerance exact.  The seeded cases draw their
transactions from a ``numpy`` generator.
"""
import asyncio
import dataclasses
import importlib
import struct

import numpy as np
import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

pytestmark = pytest.mark.ingress


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(case):
    """``case(pkg)`` on both packages; the port's result must equal the JAX
    package's.  Returns it."""
    want, got = (case(pkg) for pkg in PACKAGES)
    assert got == want
    return got


def _params(pkg, **kwargs):
    return _mod(pkg, "config").IngressParameters(**kwargs)


def _txs(n, size=32, tag=0):
    return [struct.pack("<QQ", tag, i) + b"\x00" * (size - 16) for i in range(n)]


def _seeded_txs(seed, n, size=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


class _Commit:
    def __init__(self, height, blocks):
        self.height = height
        self.blocks = blocks


class _Block:
    def __init__(self, statements):
        self.statements = statements


# -- mempool units ----------------------------------------------------------------


def test_mempool_count_cap_sheds_typed():
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        pool = ingress.Mempool(_params(pkg, mempool_max_transactions=5))
        accepted, sheds = pool.submit("a", _txs(8))
        assert accepted == 5
        assert sheds == {ingress.SHED_MEMPOOL_TXS: 3}
        assert pool.pending() == 5
        return accepted, sheds, pool.lane_stats()

    _both(case)


def test_mempool_byte_cap_sheds_typed():
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        pool = ingress.Mempool(_params(pkg, mempool_max_bytes=100))
        accepted, sheds = pool.submit("a", _txs(5, size=40))
        assert accepted == 2  # third would cross 100 bytes
        assert sheds == {ingress.SHED_MEMPOOL_BYTES: 3}
        assert pool.pending_bytes() == 80
        return accepted, sheds, pool.occupancy()

    _both(case)


def test_mempool_lane_cap_and_dedup_flood():
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        pool = ingress.Mempool(_params(pkg, lane_max_transactions=4, dedup_window=1000))
        batch = _txs(4)
        steps = [pool.submit("a", batch)]
        assert steps[-1] == (4, {})
        # Duplicate flood: identical bytes must shed as duplicate, not requeue.
        steps.append(pool.submit("a", batch))
        assert steps[-1] == (0, {ingress.SHED_DUPLICATE: 4})
        # Fresh txs beyond the lane cap shed as lane_cap.
        steps.append(pool.submit("a", _txs(2, tag=9)))
        assert steps[-1] == (0, {ingress.SHED_LANE_CAP: 2})
        # Draining frees the lane; previously-shed duplicates stay duplicates
        # (the dedup window outlives the queue residency).
        drained = pool.drain(10)
        assert len(drained) == 4
        steps.append(pool.submit("a", batch))
        assert steps[-1] == (0, {ingress.SHED_DUPLICATE: 4})
        return steps, drained, pool.lane_stats()

    _both(case)


def test_mempool_lane_table_evicts_empty_lanes(monkeypatch):
    """MAX_LANES must not be a lifetime cap: after the table fills, a new
    client evicts the oldest drained-empty lane instead of being shed
    forever."""
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        monkeypatch.setattr(ingress, "MAX_LANES", 4)
        pool = ingress.Mempool(_params(pkg))
        for i in range(4):
            assert pool.submit(f"conn-{i}", _txs(2, tag=i)) == (2, {})
        # Table full, every lane non-empty: genuine pressure, typed shed.
        assert pool.submit("conn-4", _txs(2, tag=99)) == (0, {ingress.SHED_LANE_CAP: 2})
        # Drain empties the lanes; the next new client evicts one and gets
        # admitted: a churn of short-lived connections never wedges ingress.
        drained = pool.drain(100)
        assert pool.submit("conn-5", _txs(2, tag=100)) == (2, {})
        assert len(pool._lanes) <= 4
        return drained, pool.lane_stats()

    _both(case)


def test_mempool_wrr_no_lane_starved():
    def case(pkg):
        pool = _mod(pkg, "ingress").Mempool(_params(pkg))
        pool.submit("whale", _txs(1000, tag=1))
        pool.submit("small-1", _txs(10, tag=2))
        pool.submit("small-2", _txs(10, tag=3))
        drained = pool.drain(100)
        assert len(drained) == 100
        stats = pool.lane_stats()
        # One WRR cycle serves every non-empty lane before any second turn.
        assert stats["small-1"]["drained"] > 0
        assert stats["small-2"]["drained"] > 0
        assert stats["whale"]["drained"] > 0
        return drained, stats

    _both(case)


def test_mempool_priority_lane_weight():
    def case(pkg):
        pool = _mod(pkg, "ingress").Mempool(_params(pkg, priority_weight=4))
        pool.submit("bulk", _txs(400, tag=1))
        pool.submit("urgent", _txs(400, tag=2), priority=True)
        drained = pool.drain(320)
        stats = pool.lane_stats()
        # Priority lanes take priority_weight chunks per WRR turn.
        assert stats["urgent/priority"]["drained"] >= 3 * stats["bulk"]["drained"]
        return drained, stats

    _both(case)


def test_seeded_lanes_drain_in_the_jax_packages_order():
    """Seeded 512-byte transactions from five clients (one of them a
    priority lane, some resubmissions) against tight caps, then drains of
    seeded budgets: every verdict, the drain order and the lane stats equal
    the JAX package's."""
    rng = np.random.default_rng(5)
    pool_txs = _seeded_txs(5, 900)
    plan = []
    for _ in range(60):
        client = f"c{int(rng.integers(0, 5))}"
        start = int(rng.integers(0, len(pool_txs) - 40))
        plan.append((client, client == "c4", start, int(rng.integers(1, 40)),
                     int(rng.integers(0, 120))))

    def case(pkg):
        pool = _mod(pkg, "ingress").Mempool(_params(
            pkg, mempool_max_transactions=300, mempool_max_bytes=120_000,
            lane_max_transactions=90, dedup_window=400, priority_weight=3))
        out = []
        for client, priority, start, count, budget in plan:
            out.append(pool.submit(client, pool_txs[start:start + count], priority=priority))
            out.append(pool.drain(budget))
        out.append(pool.lane_stats())
        return out

    _both(case)


# -- admission controller -----------------------------------------------------------


def _controller(pkg, **over):
    defaults = dict(admission_initial_tx_s=1000.0, admission_min_tx_s=100.0,
                    admission_additive_tx_s=50.0, admission_decrease_factor=0.5,
                    high_watermark=0.8, low_watermark=0.4)
    defaults.update(over)
    clock = {"t": 0.0}
    ctl = _mod(pkg, "ingress").AdmissionController(_params(pkg, **defaults),
                                                   clock=lambda: clock["t"])
    return ctl, clock


def test_admission_token_bucket_sheds_tail_with_retry_hint():
    def case(pkg):
        ctl, clock = _controller(pkg)
        first = ctl.admit(400)  # burst window = 0.5s * 1000/s
        assert first == (400, 0)
        second = ctl.admit(400)
        assert second[0] == 100  # bucket drained to 100 tokens
        assert second[1] >= 25  # the deficit-derived hint, floored
        clock["t"] = 1.0
        third = ctl.admit(400)
        assert third[0] == 400  # refilled at the rate
        return first, second, third

    _both(case)


def test_admission_aimd_cut_floor_and_recovery():
    def case(pkg):
        ctl, _clock = _controller(pkg)
        assert ctl.tick({"mempool_occupancy": 0.9}) == ["mempool"]
        assert ctl.rate == 500.0 and ctl.shed_mode
        for _ in range(10):
            ctl.tick({"mempool_occupancy": 0.9})
        assert ctl.rate == 100.0  # the floor holds
        assert ctl.tick({"mempool_occupancy": 0.1}) == []
        assert ctl.rate == 150.0 and not ctl.shed_mode  # additive recovery
        # Hysteresis: between the watermarks the rate holds.
        before = ctl.rate
        ctl.tick({"mempool_occupancy": 0.6})
        assert ctl.rate == before
        return ctl.rate, ctl.shed_mode

    _both(case)


def test_admission_core_queue_and_wal_signals():
    def case(pkg):
        ctl, _clock = _controller(pkg)
        reasons = ctl.tick({"mempool_occupancy": 0.5, "core_queue_depth": 30,
                            "core_queue_capacity": 32, "wal_backlog": True})
        assert reasons == ["core-queue", "wal"]
        # A WAL backlog with a drained mempool is normal at load.
        ctl2, _ = _controller(pkg)
        assert ctl2.tick({"mempool_occupancy": 0.1, "wal_backlog": True}) == []
        # The verifier's pipeline at its depth counts while the pool fills.
        ctl3, _ = _controller(pkg)
        verifier = ctl3.tick({"mempool_occupancy": 0.5, "verify_occupancy": 1.0})
        assert verifier == ["verifier"]
        return reasons, verifier, ctl.rate, ctl3.rate

    _both(case)


def test_seeded_admission_and_aimd_follow_the_jax_package():
    """Seeded admits and ticks (occupancy, core queue, WAL and verifier
    signals) on a stepped clock: every admitted count, retry hint,
    congestion list, rate and mode equals the JAX package's."""
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(200):
        if rng.random() < 0.6:
            steps.append(("admit", float(rng.uniform(0, 0.3)), int(rng.integers(0, 600))))
        else:
            steps.append(("tick", float(rng.uniform(0, 0.3)), {
                "mempool_occupancy": float(rng.uniform(0, 1.0)),
                "core_queue_depth": int(rng.integers(0, 40)), "core_queue_capacity": 32,
                "wal_backlog": bool(rng.integers(0, 2)),
                "verify_occupancy": float(rng.choice([0.0, 0.5, 1.0]))}))

    def case(pkg):
        ctl, clock = _controller(pkg)
        out = []
        for kind, dt, arg in steps:
            clock["t"] += dt
            out.append(ctl.admit(arg) if kind == "admit" else ctl.tick(dict(arg)))
            out.append((ctl.rate, ctl.shed_mode))
        return out

    _both(case)


# -- plane accounting ---------------------------------------------------------------


def test_plane_every_rejection_counted_and_logged():
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        metrics = _mod(pkg, "metrics").Metrics()
        plane = ingress.IngressPlane(_params(pkg, mempool_max_transactions=10, admission=False),
                                     metrics=metrics, clock=lambda: 1.5)
        result = plane.submit("c1", _txs(16))
        assert result.status == _mod(pkg, "network").GATEWAY_SHED
        assert result.accepted == 10 and result.shed == 6
        assert result.reason == ingress.SHED_MEMPOOL_TXS
        assert result.retry_after_ms >= 25
        # The metric family, the reason ledger, and the structured log agree.
        assert plane.shed_total() == 6
        assert plane.shed_by_reason == {ingress.SHED_MEMPOOL_TXS: 6}
        assert metrics.mysticeti_ingress_shed_total.labels(
            ingress.SHED_MEMPOOL_TXS)._value.get() == 6
        assert metrics.mysticeti_ingress_admitted_total._value.get() == 10
        (entry,) = plane.shed_log
        assert entry == {"t": 1.5, "client": "c1", "reason": ingress.SHED_MEMPOOL_TXS, "n": 6,
                         "retry_after_ms": entry["retry_after_ms"]}
        assert plane.shed_log_bytes() == plane.shed_log_bytes()
        return (result.status, result.accepted, result.shed, result.retry_after_ms,
                result.reason, plane.shed_log_bytes(), plane.shed_schedule_digest())

    _both(case)


def test_plane_status_ack_queued_shed():
    def case(pkg):
        net = _mod(pkg, "network")
        plane = _mod(pkg, "ingress").IngressPlane(_params(
            pkg, mempool_max_transactions=10, queued_watermark=0.5, admission=False))
        statuses = [plane.submit("c", _txs(2)).status, plane.submit("c", _txs(4, tag=1)).status,
                    plane.submit("c", _txs(8, tag=2)).status]
        assert statuses == [net.GATEWAY_ACK, net.GATEWAY_QUEUED, net.GATEWAY_SHED]
        return statuses, plane.health_state()

    _both(case)


def test_plane_shed_mode_transition_recorded():
    class _Rec:
        def __init__(self):
            self.events = []

        def record(self, kind, **fields):
            self.events.append((kind, fields))

    def case(pkg):
        rec = _Rec()
        plane = _mod(pkg, "ingress").IngressPlane(
            _params(pkg, mempool_max_transactions=10, admission=True), recorder=rec)
        plane.submit("c", _txs(10))
        plane.tick()  # occupancy 1.0 >= high watermark -> shed mode on
        plane.drain(10)
        plane.tick()  # drained -> recovery, shed mode off
        kinds = [(k, f["on"]) for k, f in rec.events if k == "shed-mode"]
        assert kinds == [("shed-mode", True), ("shed-mode", False)]
        return rec.events

    _both(case)


def test_seeded_plane_shed_log_and_digest_equal_the_jax_packages():
    """A plane on a stepped clock under seeded submissions from three
    clients (resubmissions among them), drains and ticks, with the finality
    tracker on: results, shed log bytes and digest, lane stats, health
    state, the finality percentiles and every ingress and finality sample
    equal the JAX package's."""
    rng = np.random.default_rng(21)
    txs = _seeded_txs(21, 2000)
    plan = []
    for _ in range(150):
        roll = rng.random()
        if roll < 0.6:
            start = int(rng.integers(0, len(txs) - 80))
            plan.append(("submit", f"client-{int(rng.integers(0, 3))}", start,
                         int(rng.integers(1, 80))))
        elif roll < 0.85:
            plan.append(("drain", int(rng.integers(0, 150))))
        else:
            plan.append(("tick",))

    def case(pkg):
        ingress = _mod(pkg, "ingress")
        metrics = _mod(pkg, "metrics").Metrics()
        clock = {"t": 0.0}
        plane = ingress.IngressPlane(_params(
            pkg, mempool_max_transactions=400, mempool_max_bytes=150_000,
            lane_max_transactions=250, admission_initial_tx_s=800.0, admission_min_tx_s=100.0,
            finality_sample_every=4), metrics=metrics, clock=lambda: clock["t"])
        out, height = [], 0
        for step in plan:
            clock["t"] += 0.05
            if step[0] == "submit":
                r = plane.submit(step[1], txs[step[2]:step[2] + step[3]])
                out.append((r.status, r.accepted, r.shed, r.retry_after_ms, r.reason))
            elif step[0] == "drain":
                drained = plane.drain(step[1])
                out.append(drained)
                height += 1
                share = _mod(pkg, "types").Share
                plane.note_committed([_Commit(height, [_Block([share(tx) for tx in drained])])])
            else:
                out.append(plane.tick())
        samples = {}
        for family in metrics.registry.collect():
            if family.name.startswith(("mysticeti_ingress", "mysticeti_e2e_finality")):
                for s in family.samples:
                    if not s.name.endswith("_created"):
                        samples[(s.name, tuple(sorted(s.labels.items())))] = s.value
        assert plane.shed_by_reason and plane.finality.completed > 0
        return (out, plane.shed_log_bytes(), plane.shed_schedule_digest(),
                plane.mempool.lane_stats(), plane.health_state(),
                plane.finality.percentiles(), samples)

    _both(case)


# -- soft-cap / dedup counter satellites -----------------------------------------


def test_legacy_soft_cap_truncation_counts(monkeypatch):
    def case(pkg):
        bh = _mod(pkg, "block_handler")
        monkeypatch.setattr(bh, "SOFT_MAX_PROPOSED_PER_BLOCK", 10)
        metrics = _mod(pkg, "metrics").Metrics()
        handler = bh.BenchmarkFastPathBlockHandler(
            _mod(pkg, "committee").Committee.new_test([1] * 4), 0, metrics=metrics)
        deferred = metrics.mysticeti_ingress_shed_total.labels("soft_cap_deferred")
        handler.submit(_txs(25))
        received = [handler._receive_with_limit()]
        assert len(received[-1]) == 10
        assert deferred._value.get() == 15
        # Nothing was lost, and the re-truncated remainder is not counted
        # again.
        handler.pending_transactions = 0
        received.append(handler._receive_with_limit())
        assert len(received[-1]) == 10
        handler.pending_transactions = 0
        received.append(handler._receive_with_limit())
        assert len(received[-1]) == 5
        assert deferred._value.get() == 15
        return received

    _both(case)


def test_aggregator_dedup_counters(tmp_path):
    def case(pkg):
        metrics = _mod(pkg, "metrics").Metrics()
        agg = _mod(pkg, "block_handler")._LoggingAggregator(
            _mod(pkg, "log").TransactionLog.start(str(tmp_path / f"{pkg}-certified.txt")),
            metrics=metrics)
        agg.duplicate_transaction("locator", 1)
        agg.duplicate_transaction("locator", 2)
        agg.unknown_transaction("locator", 3)
        dedup = metrics.mysticeti_transaction_dedup_total
        assert dedup.labels("duplicate")._value.get() == 2
        assert dedup.labels("unknown")._value.get() == 1
        return dedup.labels("duplicate")._value.get(), dedup.labels("unknown")._value.get()

    _both(case)


# -- gateway wire -------------------------------------------------------------------


def _gateway_messages(pkg):
    net = _mod(pkg, "network")
    return (net.GatewaySubmit(b"lane-a", 1, (b"tx-1", b"tx-2" * 100)),
            net.GatewaySubmit(b"", 0, ()),
            net.GatewaySubmitReply(net.GATEWAY_SHED, 3, 2, 250, b"admission"),
            net.GatewaySubmitReply(net.GATEWAY_ACK, 5, 0, 0, b""),
            net.GatewaySubscribeCommits(0),
            net.GatewaySubscribeCommits(12345),
            net.GatewayCommitNotification(7, (b"k" * 16, b"j" * 16)))


def test_gateway_wire_roundtrip():
    def case(pkg):
        net = _mod(pkg, "network")
        frames = []
        for msg in _gateway_messages(pkg):
            assert net.decode_message(net.encode_message(msg)) == msg
            frames.append(net.encode_message(msg))
        return frames

    _both(case)


def test_gateway_tags_version_skew_resets():
    def case(pkg):
        net, serde = _mod(pkg, "network"), _mod(pkg, "serde")
        # A tag from the future, and a truncated gateway frame, reject.
        with pytest.raises(serde.SerdeError):
            net.decode_message(bytes([17]) + b"\x00" * 8)
        with pytest.raises(serde.SerdeError):
            net.decode_message(net.encode_message(net.GatewaySubmit(b"c", 0, (b"tx",)))[:-2])
        return True

    _both(case)


async def _gateway_session(pkg, client_pkg):
    """A live ``pkg`` gateway on loopback driven by ``client_pkg``'s codec
    and framing, as ``test_gateway_live_submit_and_commit_stream``."""
    ingress, net, types = _mod(pkg, "ingress"), _mod(client_pkg, "network"), _mod(pkg, "types")
    plane = ingress.IngressPlane(_params(pkg, mempool_max_transactions=8, admission=False))
    gateway = await ingress.IngressGateway(plane, "127.0.0.1", 0).start()
    port = gateway._server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    replies = []

    async def send(msg):
        net._write_frame(writer, net.encode_message(msg))
        await writer.drain()

    async def receive():
        raw = await net._read_frame(reader)
        replies.append(bytes(raw))
        return net.decode_message(raw)

    try:
        # SUBMIT -> ACK.
        await send(net.GatewaySubmit(b"lane", 0, tuple(_txs(3))))
        reply = await receive()
        assert isinstance(reply, net.GatewaySubmitReply)
        assert reply.status == net.GATEWAY_ACK and reply.accepted == 3
        assert plane.mempool.lane_stats()["lane"]["pending"] == 3
        # SUBMIT past the cap -> typed SHED with retry hint.
        await send(net.GatewaySubmit(b"lane", 0, tuple(_txs(8, tag=1))))
        reply = await receive()
        assert reply.status == net.GATEWAY_SHED
        assert reply.accepted == 5 and reply.shed == 3
        assert reply.reason == ingress.SHED_MEMPOOL_TXS.encode()
        assert reply.retry_after_ms > 0
        # Commit stream: subscribe, then feed the committed sequence.
        await send(net.GatewaySubscribeCommits(0))
        await asyncio.sleep(0.05)  # subscription registered
        tx = _txs(1, tag=2)[0]
        plane.note_committed([_Commit(4, [_Block([types.Share(tx)])])])
        note = await receive()
        assert isinstance(note, net.GatewayCommitNotification)
        assert note.height == 4 and note.keys == (ingress.ingress_key(tx),)
        # Re-subscribe replaces the filter: heights at or below the new
        # from_height are suppressed while later ones flow.
        await send(net.GatewaySubscribeCommits(10))
        await asyncio.sleep(0.05)
        assert len(plane._commit_sinks) == 1
        tx2, tx3 = _txs(2, tag=3)
        plane.note_committed([_Commit(10, [_Block([types.Share(tx2)])])])
        plane.note_committed([_Commit(11, [_Block([types.Share(tx3)])])])
        note = await receive()
        assert note.height == 11 and note.keys == (ingress.ingress_key(tx3),)
    finally:
        writer.close()
        await gateway.stop()
    # The shed log's times are the loop's wall clock.
    return replies, [dict(e, t=None) for e in plane.shed_log], plane.mempool.lane_stats()


@pytest.mark.parametrize("client_pkg", PACKAGES)
def test_gateway_live_submit_and_commit_stream(client_pkg):
    """Each package's gateway on loopback, driven by ``client_pkg``'s
    framing: replies and notifications are byte for byte the same frames,
    and the planes' shed logs and lanes equal."""
    _both(lambda pkg: asyncio.run(_gateway_session(pkg, client_pkg)))


# -- closed-loop generator ----------------------------------------------------------


def test_closed_loop_generator_honors_retry_after():
    def case(pkg):
        ingress, net = _mod(pkg, "ingress"), _mod(pkg, "network")
        calls = []

        def submit(batch):
            # Sheds everything with a 500 ms hint for the first second.
            t = asyncio.get_event_loop().time()
            calls.append((round(t, 3), len(batch), tuple(batch)))
            if t < 1.0:
                return ingress.SubmitResult(net.GATEWAY_SHED, 0, len(batch), 500, "admission")
            return ingress.SubmitResult(net.GATEWAY_ACK, len(batch), 0)

        gen = _mod(pkg, "transactions_generator").TransactionGenerator(
            submit=submit, seed=3, tps=100, transaction_size=32, closed_loop=True)

        async def main():
            gen.start()
            await asyncio.sleep(3.0)
            gen.stop()

        _mod(pkg, "runtime.simulated").run_simulation(main(), seed=3)
        assert gen.shed_observed > 0 and gen.retries > 0 and gen.accepted > 0
        # During the shed window the client backed off by the hint.
        shed_window = [t for t, *_ in calls if t < 1.0]
        gaps = [b - a for a, b in zip(shed_window, shed_window[1:])]
        assert gaps and min(gaps) >= 0.45
        return calls, gen.stats()

    _both(case)


def test_seeded_generator_batches_and_stats_equal_the_jax_packages():
    """A closed-loop generator of 512-byte transactions under a 1x -> 3x
    schedule against each package's plane in the simulator, with the
    client-side finality recorder fed from the plane's commits: every batch
    (its bytes, virtual stamps included), every verdict, the stats and the
    client finality equal the JAX package's."""
    def case(pkg):
        ingress = _mod(pkg, "ingress")
        types = _mod(pkg, "types")
        plane = ingress.IngressPlane(_params(
            pkg, mempool_max_transactions=300, admission_initial_tx_s=400.0,
            admission_min_tx_s=50.0, finality_sample_every=4))
        batches = []

        def submit(batch):
            result = plane.submit("local", batch)
            batches.append((tuple(batch), dataclasses.astuple(result)))
            return result

        gen = _mod(pkg, "transactions_generator").TransactionGenerator(
            submit=submit, seed=44, tps=300, transaction_size=512,
            overload_schedule=[(0.0, 1.0), (1.5, 3.0)], closed_loop=True,
            finality_sample_every=4)
        plane.add_commit_sink(lambda height, keys, info: gen.note_commit_notification(keys, info))

        async def main():
            plane.start()
            gen.start()
            for height in range(1, 31):
                await asyncio.sleep(0.1)
                plane.note_committed([_Commit(height, [_Block(
                    [types.Share(tx) for tx in plane.drain(25)])])])
            gen.stop()
            plane.stop()

        _mod(pkg, "runtime.simulated").run_simulation(main(), seed=44)
        stats = gen.stats()
        assert stats["shed_observed"] > 0 and stats["retries"] > 0
        assert stats["client_finality_samples"] > 0
        return batches, stats, plane.shed_schedule_digest()

    _both(case)


def test_overload_schedule_multiplier():
    def case(pkg):
        tg = _mod(pkg, "transactions_generator")
        schedule = tg.parse_overload_schedule("0:1, 30:3, 60:5")
        assert schedule == [(0.0, 1.0), (30.0, 3.0), (60.0, 5.0)]
        gen = tg.TransactionGenerator(submit=lambda b: None, seed=0, tps=100,
                                      transaction_size=32, overload_schedule=schedule)
        got = [gen.multiplier(t) for t in (0.0, 29.9, 30.0, 61.0)]
        assert got == [1.0, 1.0, 3.0, 5.0]
        return schedule, got, tg.TransactionGenerator.extract_timestamp(
            struct.pack("<d", 12.5) + b"\x00" * 8)

    _both(case)


def test_ingress_parameters_yaml_roundtrip(tmp_path):
    import yaml

    def case(pkg):
        Parameters = _mod(pkg, "config").Parameters
        p = Parameters()
        p.ingress.mempool_max_transactions = 777
        p.ingress.gateway_port_base = 9000
        path = str(tmp_path / f"{pkg}-parameters.yaml")
        p.dump(path)
        loaded = Parameters.load(path)
        assert loaded.ingress.mempool_max_transactions == 777
        assert loaded.ingress.gateway_port_base == 9000
        # A file without the block loads with defaults.
        with open(path) as f:
            raw = yaml.safe_load(f.read())
        raw.pop("ingress")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        assert Parameters.load(path).ingress.enabled
        return loaded.ingress

    want, got = (case(pkg) for pkg in PACKAGES)
    assert vars(got) == vars(want)


def test_overload_scenario_parameters_equal_the_jax_packages():
    """The ingress-10 cell's scenario and the reference's tier-1 one: the
    port's ``ingress_parameters()`` and ``to_dict()`` equal the JAX
    package's."""
    def case(pkg, **kwargs):
        scenario = _mod(pkg, "ingress").OverloadScenario(**kwargs)
        return vars(scenario.ingress_parameters()), scenario.to_dict()

    for kwargs in (dict(nodes=10, duration_s=12, base_tps=1000,
                        multiplier_schedule=[(0.0, 1.0), (5.0, 3.0)], closed_loop=True,
                        transaction_size=512, max_per_proposal=200,
                        mempool_max_transactions=4000, leader_timeout_s=1.0),
                   dict(seed=11, nodes=10, duration_s=8.0, base_tps=300, max_per_proposal=30,
                        mempool_max_transactions=600, multiplier_schedule=[(0.0, 3.0)],
                        clients_per_node=3, duplicate_flood=True)):
        want, got = (case(pkg, **kwargs) for pkg in PACKAGES)
        assert got == want


# -- execution plane: typed sheds, identity lanes, deferred notifications ------------


class _FakeCore:
    """Just enough core surface for IngressPlane.attach(core=...)."""

    def __init__(self, execution):
        self.execution = execution
        self.execution_listeners = []

    def fold(self, height, blocks):
        result = self.execution.observe_commit(height, blocks)
        if result is not None:
            for listener in self.execution_listeners:
                listener(result)
        return result


def _exec_block(pkg, *txs):
    return _Block([_mod(pkg, "types").Share(tx.to_bytes()) for tx in txs])


def _plane_with_execution(pkg, **params):
    ex = _mod(pkg, "execution")
    state = ex.ExecutionState()
    state.observe_commit(1, [_exec_block(pkg, ex.ExecTx(ex.OP_CREATE, b"alice", amount=100))])
    core = _FakeCore(state)
    plane = _mod(pkg, "ingress").IngressPlane(_params(pkg, admission=False, **params)).attach(
        core=core)
    return plane, core, state


def test_ingress_sheds_doomed_exec_txs_before_consensus():
    def case(pkg):
        ex, ingress = _mod(pkg, "execution"), _mod(pkg, "ingress")
        plane, _, _ = _plane_with_execution(pkg)
        result = plane.submit("client", [
            ex.ExecTx(ex.OP_CREATE, b"alice").to_bytes(),
            ex.ExecTx(ex.OP_MINT, b"alice", nonce=0, amount=1).to_bytes(),
            ex.ExecTx(ex.OP_MINT, b"ghost", nonce=0).to_bytes(),
            ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=999, dest=b"b").to_bytes(),
            ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=10, dest=b"b").to_bytes(),
        ])
        assert result.accepted == 1 and result.shed == 4
        assert plane.shed_by_reason == {
            ingress.SHED_ACCOUNT_EXISTS: 1, ingress.SHED_BAD_NONCE: 1,
            ingress.SHED_UNKNOWN_ACCOUNT: 1, ingress.SHED_INSUFFICIENT_BALANCE: 1}
        # Nothing doomed reached the mempool.
        assert plane.mempool.pending() == 1
        # The shed log's times are the runtime clock's (here the wall's).
        return result.reason, [dict(e, t=None) for e in plane.shed_log]

    _both(case)


def test_ingress_identity_lanes_key_on_spending_account():
    def case(pkg):
        ex = _mod(pkg, "execution")
        plane, _, _ = _plane_with_execution(pkg)
        valid = ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=10, dest=b"b").to_bytes()
        ordinary = struct.pack("<QQ", 7, 1) + b"\x00" * 16
        assert plane.submit("conn-1", [valid, ordinary]).accepted == 2
        stats = plane.mempool.lane_stats()
        # The execution tx laned by account, the ordinary one by the caller.
        account_lane = f"acct:{b'alice'.hex()}"
        assert stats[account_lane]["pending"] == 1
        assert stats["conn-1"]["pending"] == 1
        # A second connection spending the same account shares its lane.
        valid2 = ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=2, amount=10, dest=b"c").to_bytes()
        assert plane.submit("conn-2", [valid2]).accepted == 1
        assert plane.mempool.lane_stats()[account_lane]["pending"] == 2
        return plane.mempool.lane_stats(), plane.drain(10)

    _both(case)


def test_ingress_defers_notification_until_executed():
    def case(pkg):
        ex, ingress = _mod(pkg, "execution"), _mod(pkg, "ingress")
        plane, core, state = _plane_with_execution(pkg)
        seen = []
        plane.add_commit_sink(lambda h, keys, info: seen.append((h, keys, info)))
        tx = ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=10, dest=b"b")
        block = _exec_block(pkg, tx)
        # The observer feed runs before the core folds: the notification
        # buffers.
        plane.note_committed([_Commit(2, [block])])
        assert seen == [] and len(plane._pending_exec) == 1
        # The fold flushes it with the root attached.
        core.fold(2, [block])
        ((height, keys, info),) = seen
        assert height == 2 and keys == [ingress.ingress_key(tx.to_bytes())]
        assert info["executed_height"] == 2 and info["executed_root"] == state.root
        assert plane.executed_height == 2 and plane.executed_root == state.root
        health = plane.health_state()
        assert health["execution"] == {"executed_height": 2, "executed_root": state.root.hex()}
        del info["committed_ts_ns"]  # the wall clock's
        return height, keys, info, health

    _both(case)


async def _executed_session(pkg):
    ex, ingress, net = _mod(pkg, "execution"), _mod(pkg, "ingress"), _mod(pkg, "network")
    plane, core, state = _plane_with_execution(pkg)
    resume_root = state.root
    gateway = await ingress.IngressGateway(plane, "127.0.0.1", 0).start()
    port = gateway._server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        net._write_frame(writer, net.encode_message(
            net.GatewaySubscribeCommits(0, want_executed=1)))
        await writer.drain()
        first = net.decode_message(await net._read_frame(reader))
        assert isinstance(first, net.GatewayCommitNotification)
        assert first.height == 1 and first.keys == ()
        assert first.executed_root == resume_root
        tx = ex.ExecTx(ex.OP_TRANSFER, b"alice", nonce=1, amount=10, dest=b"b")
        block = _exec_block(pkg, tx)
        plane.note_committed([_Commit(2, [block])])
        core.fold(2, [block])
        note = net.decode_message(await net._read_frame(reader))
        assert note.height == 2 and note.keys == (ingress.ingress_key(tx.to_bytes()),)
        assert note.executed_root == state.root
    finally:
        writer.close()
        await gateway.stop()
    return (first.height, first.keys, first.executed_root,
            note.height, note.keys, note.executed_root)


def test_gateway_subscribe_executed_resume_reply_and_stream():
    """A ``want_executed`` subscriber gets a synthetic notification pinning
    the executed height and root, then live notifications carrying the
    EXECUTED suffix."""
    _both(lambda pkg: asyncio.run(_executed_session(pkg)))
