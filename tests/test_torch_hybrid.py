"""The port's hybrid CPU/GPU router against the JAX package's.

Each scenario of the JAX package's router tests runs on both classes with
the same stub backends and an injected clock (the breaker's clock and the
``time.monotonic`` the cost model reads), and must give the same routes,
thresholds, EMA values, breaker trips, closes and probe releases.  The
port-only tests show that a kernel build or load failure propagates out of
the router without tripping its breaker, that a cancelled flush releases
the probe it owned, and that the ``cuda`` node kind gives the JAX CPU
collector's verdicts.
"""
import asyncio
import threading
import types

import pytest

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu import committee as JC
from mysticeti_tpu import crypto as JCR
from mysticeti_tpu import types as JT
from mysticeti_tpu_torch import block_validator as PBV
from mysticeti_tpu_torch import committee as PC
from mysticeti_tpu_torch import crypto as PCR
from mysticeti_tpu_torch import types as PT
from mysticeti_tpu_torch.ops import cuda_build
from mysticeti_tpu_torch.ops import ed25519_cuda as K
from mysticeti_tpu_torch.validator import HYBRID_KIND, _make_verifier

from test_torch_slice import N_AUTH, _signed_block_bytes, _verdicts

SIDES = {
    "jax": types.SimpleNamespace(bv=JBV, committee=JC, crypto=JCR, types=JT),
    "port": types.SimpleNamespace(bv=PBV, committee=PC, crypto=PCR, types=PT),
}


class Clock:
    """One injected clock for the breaker and the cost model; stub backends
    advance it by what their dispatch "costs"."""

    def __init__(self) -> None:
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for side in SIDES.values():
        monkeypatch.setattr(side.bv, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


def _stub(bv, clock, cost_s=0.0, per_sig_s=0.0):
    class Recorder(bv.SignatureVerifier):
        def __init__(self):
            self.calls = []
            self.down = False

        def verify_signatures(self, pks, digests, sigs):
            clock.t += cost_s + per_sig_s * len(sigs)
            if self.down:
                raise ConnectionError("backend down")
            self.calls.append(len(sigs))
            return [True] * len(sigs)

    return Recorder()


def _args(n):
    return [b"\0" * 32] * n, [b"\1" * 32] * n, [b"\2" * 64] * n


def _state(h):
    return (h.backend_label, h.threshold(), h.tpu_dispatch_s, h.tpu_per_sig_s, h.cpu_per_sig_s,
            h.breaker_open, h._breaker_backoff_s, h._breaker_open_until, h._breaker_probing,
            h.pinned_backend)


def scenario_routes_by_batch_size(side, clock):
    tpu, cpu = _stub(side.bv, clock, 0.05), _stub(side.bv, clock, 0.0, 100e-6)
    h = side.bv.HybridSignatureVerifier(tpu=tpu, cpu=cpu)
    h._breaker_clock = clock.monotonic
    h.tpu_dispatch_s = 0.100
    h.cpu_per_sig_s = 100e-6
    assert h.threshold() == 101
    trace = [_state(h)]
    h.verify_signatures(*_args(5))
    assert cpu.calls == [5] and tpu.calls == []
    assert h.backend_label == "hybrid-cpu"
    trace.append(_state(h))
    h.verify_signatures(*_args(256))
    assert tpu.calls == [256] and h.backend_label == "hybrid-tpu"
    assert 0 < h.tpu_dispatch_s < 0.2
    trace.append(_state(h))
    assert h.verify_signatures([], [], []) == []
    return trace


def scenario_fixed_threshold_and_default(side, clock):
    h = side.bv.HybridSignatureVerifier(tpu=_stub(side.bv, clock), threshold=7)
    assert h.threshold() == 7
    h2 = side.bv.HybridSignatureVerifier(tpu=_stub(side.bv, clock))
    assert h2.threshold() == h2.DEFAULT_THRESHOLD
    return [h.threshold(), h2.threshold(), h2.DEFAULT_THRESHOLD]


def scenario_end_to_end_cpu_backends(side, clock):
    signers = side.committee.Committee.benchmark_signers(4)
    committee = side.committee.Committee(
        [side.committee.Authority(1, s.public_key) for s in signers])
    trace = []

    async def main():
        for threshold in (0, 100):  # force the accelerator route, then the CPU route
            h = side.bv.HybridSignatureVerifier(
                tpu=side.bv.CpuSignatureVerifier(), cpu=side.bv.CpuSignatureVerifier(),
                threshold=threshold)
            verifier = side.bv.BatchedSignatureVerifier(committee, h, max_batch=10,
                                                        max_delay_s=0.01)
            good = side.types.StatementBlock.build(0, 1, [], (), signer=signers[0])
            forged = side.types.StatementBlock.build(1, 1, [], (), signer=signers[0])
            results = await asyncio.gather(verifier.verify(good), verifier.verify(forged),
                                           return_exceptions=True)
            assert results[0] is None
            assert isinstance(results[1], side.types.VerificationError)
            trace.append((threshold, results[0], type(results[1]).__name__))

    asyncio.run(main())
    return trace


def scenario_breaker_trips_and_closes(side, clock):
    tpu, cpu = _stub(side.bv, clock, 0.004, 1e-6), _stub(side.bv, clock, 0.0, 100e-6)
    h = side.bv.HybridSignatureVerifier(tpu=tpu, cpu=cpu)
    h._breaker_clock = clock.monotonic
    h.tpu_dispatch_s, h.cpu_per_sig_s = 0.004, 100e-6
    trace = [_state(h)]
    tpu.down = True
    assert h.verify_signatures(*_args(256)) == [True] * 256  # degraded to the oracle
    assert h.breaker_open and cpu.calls == [256]
    trace.append(_state(h))
    h.verify_signatures(*_args(256))  # blocked: never touches the backend
    assert cpu.calls == [256, 256] and tpu.calls == []
    trace.append(_state(h))
    clock.t = h._breaker_open_until + 0.001
    h.verify_signatures(*_args(256))  # the probe fails: backoff doubles
    assert h._breaker_backoff_s == 2 * h.BREAKER_BASE_BACKOFF_S and not h._breaker_probing
    trace.append(_state(h))
    tpu.down = False
    clock.t = h._breaker_open_until + 0.001
    h.verify_signatures(*_args(256))  # the probe succeeds: closed
    assert not h.breaker_open and tpu.calls == [256] and h.backend_label == "hybrid-tpu"
    trace.append(_state(h))
    return trace


def scenario_pin_probe_abandon_releases_exclusivity(side, clock):
    class StubRemote(side.bv.SignatureVerifier):
        advertised_backend = "cpu"
        rehello_result = ("cpu", None)

        def rehello(self):
            return self.rehello_result

        def verify_signatures(self, *args):
            raise AssertionError("pinned batch reached the remote backend")

    signers = side.committee.Committee.benchmark_signers(4)
    digest = side.crypto.blake2b_256(b"pin-abandon")
    pks = [signers[0].public_key.bytes] * 2
    digests, sigs = [digest] * 2, [signers[0].sign(digest)] * 2
    remote = StubRemote()
    h = side.bv.HybridSignatureVerifier(tpu=remote, cpu=side.bv.CpuSignatureVerifier())
    h._breaker_clock = clock.monotonic
    h._sync_pin_with_advertisement()
    assert h.pinned_backend == "cpu"
    trace = [_state(h)]
    clock.t = 100.0  # past the probe deadline
    handle = h.verify_signatures_async(pks, digests, sigs)
    assert isinstance(handle, side.bv._PinProbeDispatch)
    assert h._breaker_probing
    handle.abandon()
    assert not h._breaker_probing, "abandon leaked the probe flag"
    assert h.pinned_backend == "cpu"
    trace.append(_state(h))
    remote.rehello_result = (None, None)
    clock.t = 10_000.0
    handle = h.verify_signatures_async(pks, digests, sigs)
    assert isinstance(handle, side.bv._PinProbeDispatch)
    assert handle.result() == [True, True]
    assert h.pinned_backend is None and not h._breaker_probing
    trace.append(_state(h))
    return trace


def scenario_never_offloads_to_a_degraded_backend(side, clock):
    h = side.bv.HybridSignatureVerifier(tpu=_stub(side.bv, clock))
    h.cpu_per_sig_s = 125e-6
    h.tpu_dispatch_s = 1.5
    routes = [h._route_to_tpu(256), h._route_to_tpu(4096)]
    assert routes == [False, False]
    h.tpu_dispatch_s = 0.150
    routes.append(h._route_to_tpu(256))
    assert routes[-1]
    h.tpu_per_sig_s = 0.005
    routes.append(h._route_to_tpu(256))
    assert not routes[-1]
    h.tpu_per_sig_s = 0.0
    routes.append(h._route_to_tpu(3))
    assert not routes[-1]
    return routes + [h.threshold()]


def scenario_ema_splits_residual_between_fixed_and_marginal(side, clock):
    h = side.bv.HybridSignatureVerifier(tpu=_stub(side.bv, clock), cpu=_stub(side.bv, clock))
    h.tpu_dispatch_s = 0.1
    h.tpu_per_sig_s = 0.0005
    n = 100
    before = h._tpu_time(n)
    h._absorb_tpu_sample(before + 0.2, n)
    after = h._tpu_time(n)
    assert after - before == pytest.approx(0.2 * 0.2, rel=1e-6)
    h._absorb_tpu_sample(h._tpu_time(n) - 0.1, n)
    assert h._tpu_time(n) < after
    frozen = (h.tpu_dispatch_s, h.tpu_per_sig_s)
    h._absorb_tpu_sample(h.EMA_OUTLIER_S + 1.0, n)
    assert (h.tpu_dispatch_s, h.tpu_per_sig_s) == frozen
    return [before, after, frozen]


SCENARIOS = [
    scenario_routes_by_batch_size,
    scenario_fixed_threshold_and_default,
    scenario_end_to_end_cpu_backends,
    scenario_breaker_trips_and_closes,
    scenario_pin_probe_abandon_releases_exclusivity,
    scenario_never_offloads_to_a_degraded_backend,
    scenario_ema_splits_residual_between_fixed_and_marginal,
]


@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[len("scenario_"):])
def test_router_scenario(scenario, side, clock):
    trace = scenario(SIDES[side], clock)
    if side == "port":
        clock.t = 0.0
        assert trace == scenario(SIDES["jax"], clock)


@pytest.mark.parametrize("failure", ["load", "build_dir"])
def test_a_kernel_load_failure_propagates_and_never_trips_the_breaker(
        failure, tmp_path, monkeypatch):
    if failure == "load":  # a library that exists but does not load
        bad = tmp_path / "libprologue-bad.so"
        bad.write_bytes(b"not a shared library")
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(cuda_build, "library_path", lambda name: bad)
    else:  # the build directory cannot be made
        (tmp_path / "file").write_text("")
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "file" / "cuda")
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(K.PROLOGUE, "_fn", None)

    class FirstLaunch(PBV.TorchSignatureVerifier):
        """Does what the first kernel launch on a card does: load the
        prologue's library."""

        def verify_signatures_async(self, *args):
            K.PROLOGUE._function()
            return super().verify_signatures_async(*args)

    cpu = PBV.CpuSignatureVerifier()
    cpu.verify_signatures = lambda *a: pytest.fail("the batch fell back to the CPU oracle")
    h = PBV.HybridSignatureVerifier(tpu=FirstLaunch(device="cpu"), cpu=cpu, threshold=0)
    with pytest.raises(cuda_build.CudaBuildError) as err:
        h.verify_signatures(*_args(3))
    assert isinstance(err.value, RuntimeError)
    assert not isinstance(err.value, h.BREAKER_EXCEPTIONS)
    assert not h.breaker_open and not h._breaker_probing


def test_a_cancelled_flush_releases_the_probe_it_owned():
    signers = PC.Committee.benchmark_signers(4)
    committee = PC.Committee.new_for_benchmarks(4)
    block = PT.StatementBlock.build(0, 1, [], (), signer=signers[0])
    entered, release = threading.Event(), threading.Event()

    class SlowSubmit(PBV.SignatureVerifier):
        def verify_signatures_async(self, *args):
            entered.set()
            assert release.wait(10)
            return PBV.DeferredDispatch(lambda: [True])

    h = PBV.HybridSignatureVerifier(tpu=SlowSubmit(), cpu=PBV.CpuSignatureVerifier(), threshold=0)
    t = [0.0]
    h._breaker_clock = lambda: t[0]
    h._trip_breaker(ConnectionError("outage"))
    t[0] = h._breaker_open_until + 1.0  # the next batch is the probe
    collector = PBV.BatchedSignatureVerifier(committee, h)

    async def main():
        task = asyncio.ensure_future(collector._direct([block]))
        while not entered.is_set():
            await asyncio.sleep(0.001)
        assert h._breaker_probing
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        release.set()
        for _ in range(1000):
            if not h._breaker_probing:
                break
            await asyncio.sleep(0.005)

    asyncio.run(main())
    assert not h._breaker_probing, "the cancelled probe stranded the exclusivity flag"
    assert h.breaker_open


def test_hybrid_entry_points_raise_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _make_verifier(HYBRID_KIND, PC.Committee.new_for_benchmarks(N_AUTH))
    with pytest.raises(RuntimeError, match="CUDA"):
        PBV.HybridSignatureVerifier()


def test_cuda_kind_verdicts_equal_the_jax_cpu_collector():
    raws = _signed_block_bytes()
    committee = PC.Committee.new_for_benchmarks(N_AUTH)
    port = _make_verifier(HYBRID_KIND, committee, device="cpu")
    assert port.ready.wait(300)
    hybrid = port.verifier
    assert isinstance(hybrid, PBV.HybridSignatureVerifier)
    assert hybrid.tpu_dispatch_s > 0 and hybrid.cpu_per_sig_s > 0
    got = _verdicts(PT.StatementBlock.from_bytes, committee, port, raws)
    jcommittee = JC.Committee.new_for_benchmarks(N_AUTH)
    reference = JBV.BatchedSignatureVerifier(jcommittee, JBV.CpuSignatureVerifier())
    assert got == _verdicts(JT.StatementBlock.from_bytes, jcommittee, reference, raws)
    assert got.count(False) == 4
    assert not hybrid.breaker_open
    # Both routes give the same verdicts: force each in turn.
    for threshold in (0, 1 << 20):
        hybrid._fixed_threshold = threshold
        assert _verdicts(PT.StatementBlock.from_bytes, committee, port, raws) == got
