"""The port's finality SLI plane (``finality.py``) against the JAX package's.

The port's counterparts of ``tests/test_decisions.py``'s finality section
(content-based key sampling, the nearest-rank percentile, the phase tracker,
its pending cap, the client-side recorder, the mempool's admission and
proposal stamps) and of ``tests/test_execution.py``'s two finality tests
(the ``total`` phase closing at execute or at commit).  Each case runs on
both packages, holds each to the reference's assertions and requires the two
to give the same values: sampled sets, samples, states and histogram sums,
with tolerance exact.  The seeded cases draw their keys and stamps from a
``numpy`` generator.
"""
import importlib

import numpy as np
import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")

pytestmark = pytest.mark.finality


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(case):
    """``case(pkg)`` on both packages; the port's result must equal the JAX
    package's.  Returns it."""
    want, got = (case(pkg) for pkg in PACKAGES)
    assert got == want
    return got


def _clock_factory(start=10.0, step=0.25):
    state = {"t": start}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def _hist_sums(metrics, phases):
    hist = metrics.mysticeti_e2e_finality_seconds
    return {phase: (hist.labels(phase)._sum.get(), metrics.registry.get_sample_value(
        "mysticeti_e2e_finality_seconds_count", {"phase": phase})) for phase in phases}


# -- finality sampling + phase tracker ------------------------------------------


def test_key_sampling_is_content_deterministic():
    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        keys = [ingress.ingress_key(b"tx-%d" % i) for i in range(400)]
        first = [fin.key_sampled(k, 16) for k in keys]
        assert first == [fin.key_sampled(k, 16) for k in keys]
        assert 0 < sum(first) < len(keys)  # neither none nor all
        assert all(fin.key_sampled(k, 1) for k in keys)
        assert all(fin.key_sampled(k, 0) for k in keys)
        return keys, first

    _both(case)


@pytest.mark.parametrize("every", [2, 16, 97])
def test_seeded_keys_sample_the_jax_packages_set(every):
    """512-byte transactions drawn from a seed: the port's ``ingress_key``
    gives the JAX package's bytes and ``key_sampled`` its sampled set."""
    rng = np.random.default_rng(every)
    txs = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(500)]

    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        keys = [ingress.ingress_key(tx) for tx in txs]
        return keys, [i for i, k in enumerate(keys) if fin.key_sampled(k, every)]

    keys, sampled = _both(case)
    assert all(len(k) == 16 for k in keys) and 0 < len(sampled) < len(keys)


def test_percentile_nearest_rank():
    def case(pkg):
        percentile = _mod(pkg, "finality").percentile
        assert percentile([], 0.99) == 0.0
        values = [float(v) for v in range(1, 101)]
        assert percentile(values, 0.50) == 51.0
        assert percentile(values, 0.99) == 100.0
        rng = np.random.default_rng(7)
        drawn = rng.uniform(0.0, 5.0, 333).tolist()
        return [percentile(drawn, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]

    _both(case)


def test_tracker_phase_stamps_and_notify():
    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        tracker = fin.FinalityTracker(sample_every=1, clock=_clock_factory())
        key = ingress.ingress_key(b"tx")
        tracker.on_submit(key, 1.0, 1.1)
        tracker.on_proposal(key, 1.3)
        tracker.on_proposal(key, 9.9)  # second drain of the key: ignored
        tracker.on_commit(key, 1.6, 1.8)
        tracker.on_commit(key, 9.9, 9.9)  # duplicate commit: ignored
        assert tracker.samples() == [pytest.approx(0.8)]  # 1.8 - 1.0
        state = tracker.state()
        assert state["completed"] == 1 and state["pending"] == 1
        tracker.on_notify([key], 2.0)
        after = tracker.state()
        assert after["pending"] == 0
        assert tracker.percentiles()["p50_s"] == pytest.approx(0.8)
        return tracker.samples(), state, after, tracker.percentiles()

    _both(case)


def test_tracker_pending_cap_evicts_oldest():
    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        tracker = fin.FinalityTracker(sample_every=1, pending_cap=16, clock=_clock_factory())
        keys = [ingress.ingress_key(b"cap-%d" % i) for i in range(20)]
        for i, key in enumerate(keys):
            tracker.on_submit(key, float(i), float(i))
        assert tracker.state()["pending"] == 16
        assert tracker.state()["expired"] == 4
        # The evicted earliest key no longer completes.
        tracker.on_commit(keys[0], 30.0, 30.0)
        assert tracker.state()["completed"] == 0
        return tracker.state()

    _both(case)


def test_client_recorder_keeps_first_submit_stamp():
    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        recorder = fin.ClientFinalityRecorder(sample_every=1,
                                              clock=_clock_factory(start=0.0, step=1.0))
        key = ingress.ingress_key(b"retry")
        recorder.note_submitted(key)  # t=1
        recorder.note_submitted(key)  # retry at t=2: first stamp kept
        recorder.note_finalized([key, ingress.ingress_key(b"unknown")])  # t=3
        assert recorder.samples() == [pytest.approx(2.0)]
        assert recorder.completed == 1
        assert recorder.percentiles()["p50_s"] == pytest.approx(2.0)
        return recorder.samples(), recorder.percentiles()

    _both(case)


def test_mempool_stamps_admission_and_proposal_phases():
    def case(pkg):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        metrics = _mod(pkg, "metrics").Metrics()
        tracker = fin.FinalityTracker(metrics=metrics, sample_every=1,
                                      clock=_clock_factory(start=0.0, step=0.5))
        pool = ingress.Mempool(_mod(pkg, "config").IngressParameters(), finality=tracker)
        txs = [b"stamped-%d" % i for i in range(3)]
        accepted, _ = pool.submit("c", txs, t_submit=0.1)
        assert accepted == 3
        drained = pool.drain(10)
        assert sorted(drained) == sorted(txs)
        tracker.on_commit(ingress.ingress_key(txs[0]), 5.0, 5.5)
        assert tracker.state()["completed"] == 1
        # submit observed admission for all 3, drain observed proposal for
        # all 3, commit closed one total = 5.5 - 0.1.
        assert tracker.samples() == [pytest.approx(5.4)]
        return drained, tracker.samples(), _hist_sums(
            metrics, ("admission", "proposal", "commit", "finalize", "total"))

    _both(case)


def test_seeded_lifecycle_gives_the_jax_packages_samples_and_histograms():
    """400 keys through submit, proposal, commit, execute and notify at
    seeded stamps (some skipped, some repeated, some past the pending cap),
    on a tracker with ``execute_expected`` and one without: samples, states,
    percentiles, exported gauges and every phase's histogram sum and count
    equal the JAX package's."""
    rng = np.random.default_rng(12)
    events = []
    for i in range(400):
        t = float(i) * 0.01
        events.append(("submit", i, t, t + float(rng.uniform(0, 0.05))))
        if rng.random() < 0.9:
            events.append(("proposal", i, t + float(rng.uniform(0.05, 0.3))))
        if rng.random() < 0.8:
            commit = t + float(rng.uniform(0.3, 2.0))
            events.append(("commit", i, commit, commit + float(rng.uniform(0, 0.1))))
            events.append(("execute", i, commit + 0.2))
            if rng.random() < 0.5:
                events.append(("notify", i, commit + 0.3))
    order = rng.permutation(len(events))
    events = [events[k] for k in sorted(order, key=lambda k: (events[k][2], k))]

    def case(pkg, execute_expected):
        fin, ingress = _mod(pkg, "finality"), _mod(pkg, "ingress")
        metrics = _mod(pkg, "metrics").Metrics()
        tracker = fin.FinalityTracker(metrics=metrics, sample_every=3, pending_cap=64,
                                      sample_window=100)
        tracker.execute_expected = execute_expected
        keys = [ingress.ingress_key(b"seeded-%d" % i) for i in range(400)]
        for kind, i, *stamps in events:
            key = keys[i]
            if not tracker.sampled(key):
                continue
            if kind == "submit":
                tracker.on_submit(key, *stamps)
            elif kind == "proposal":
                tracker.on_proposal(key, *stamps)
            elif kind == "commit":
                tracker.on_commit(key, *stamps)
            elif kind == "execute":
                tracker.on_execute([key], *stamps)
            else:
                tracker.on_notify([key], *stamps)
        tracker.export_gauges()
        return (tracker.samples(), tracker.state(), tracker.percentiles(),
                metrics.registry.get_sample_value("mysticeti_e2e_finality_p50_seconds"),
                metrics.registry.get_sample_value("mysticeti_e2e_finality_p99_seconds"),
                _hist_sums(metrics, _mod(pkg, "finality").PHASES))

    for execute_expected in (False, True):
        want, got = (case(pkg, execute_expected) for pkg in PACKAGES)
        assert got == want
        assert got[1]["completed"] > 0 and got[1]["expired"] > 0


# -- execute-phase finality (tests/test_execution.py) ----------------------------


def test_finality_total_closes_at_execute_when_expected():
    def case(pkg):
        metrics = _mod(pkg, "metrics").Metrics()
        tracker = _mod(pkg, "finality").FinalityTracker(metrics=metrics, sample_every=1)
        tracker.execute_expected = True
        key = b"k" * 16
        tracker.on_submit(key, 1.0, 1.1)
        tracker.on_commit(key, 2.0, 2.2)
        # Committed but not executed: the headline total is still open.
        assert tracker.completed == 0 and tracker.samples() == []
        tracker.on_execute([key], 2.5)
        assert tracker.completed == 1
        assert tracker.samples() == [pytest.approx(1.5)]
        # The execute phase is finalize -> execute; notify measures from the
        # EXECUTE stamp, not finalize.
        tracker.on_notify([key], 2.6)
        hist = metrics.mysticeti_e2e_finality_seconds
        assert hist.labels("execute")._sum.get() == pytest.approx(0.3)
        assert hist.labels("notify")._sum.get() == pytest.approx(0.1)
        assert hist.labels("total")._sum.get() == pytest.approx(1.5)
        return tracker.samples(), _hist_sums(metrics, ("execute", "notify", "total"))

    _both(case)


def test_finality_total_closes_at_commit_without_execution():
    def case(pkg):
        tracker = _mod(pkg, "finality").FinalityTracker(sample_every=1)
        key = b"k" * 16
        tracker.on_submit(key, 1.0, 1.1)
        tracker.on_commit(key, 2.0, 2.2)
        assert tracker.completed == 1
        assert tracker.samples() == [pytest.approx(1.2)]
        return tracker.samples(), tracker.state()

    _both(case)
