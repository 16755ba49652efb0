"""Pluggable block verification seam, with the batched GPU signature verifier.

The port's copy of ``mysticeti_tpu.block_validator``, trimmed to the node's
accelerator path: ``BlockVerifier`` / ``AcceptAllBlockVerifier``, the
``SignatureVerifier`` backends (the CPU oracle and ``TorchSignatureVerifier``,
the counterpart of ``TpuSignatureVerifier``, sharding over the host's cards
through ``parallel.mesh``), the hybrid CPU/GPU router
``HybridSignatureVerifier`` with its circuit breaker, the batching collector
``BatchedSignatureVerifier`` (with its threshold-aggregate mode), and the
threshold-aggregate rule itself (``aggregate_verify``,
``ThresholdAggregateVerifier``).  The verifier service and its client
(``RemoteSignatureVerifier``) are in verifier_service.py.

Split of responsibilities on the receive path:
  * consensus-rule checks (digest, epoch, author, includes, threshold clock) —
    host, cheap, per-block: ``StatementBlock.verify_structure``
  * Ed25519 signature — batched: ``BatchedSignatureVerifier`` over
    ``HybridSignatureVerifier`` / ``TorchSignatureVerifier`` (CUDA kernels)
    or ``CpuSignatureVerifier``
"""
from __future__ import annotations

import asyncio
import contextvars
import itertools
import random
import threading
import time
from itertools import islice
from time import thread_time
from typing import List, Optional, Sequence, Tuple

from . import spans
from .committee import Committee
from .network import jittered_backoff
from .runtime import is_simulated
from .tracing import logger
from .types import StatementBlock, VerificationError
from .utils.tasks import spawn_logged
from .verify_pipeline import (
    STAGE_DEVICE,
    STAGE_FETCH,
    STAGE_PACK,
    STAGE_QUEUE,
    CompletedDispatch,
    DeferredDispatch,
    VerifyPipeline,
)

log = logger(__name__)


class VerifierProtocolError(ConnectionError):
    """A verifier backend answered but REJECTED the request (committee
    mismatch, malformed frame).  Retrying cannot help and the circuit
    breaker must NOT treat it as an outage: a misconfigured validator fails
    fast instead of silently serving on the CPU oracle forever."""


class BlockVerifier:
    """Application-content verification hook (block_validator.rs:10-14)."""

    async def verify(self, block: StatementBlock) -> None:
        """Raise VerificationError to reject."""
        raise NotImplementedError

    async def verify_blocks(self, blocks: Sequence[StatementBlock]) -> List[bool]:
        """Batch entry; default falls back to per-block verify."""
        out = []
        for b in blocks:
            try:
                await self.verify(b)
                out.append(True)
            except VerificationError:
                out.append(False)
        return out

    def note_committee(self, committee: "Committee") -> None:
        """Epoch reconfiguration hook (reconfig.py): the committee's stake
        table changed at a boundary commit.  Registry KEYS are stable
        (stable-index membership), so signature tables need no rebuild —
        only stake-weighted math (quorum endorsement) must follow the new
        committee.  Default: nothing stake-weighted here."""
        return None


class AcceptAllBlockVerifier(BlockVerifier):
    """block_validator.rs:18-27."""

    async def verify(self, block: StatementBlock) -> None:
        return None


class SignatureVerifier:
    """Synchronous batch signature check: (pubkeys, digests, signatures) -> bools."""

    def verify_signatures(
        self,
        public_keys: Sequence[bytes],
        digests: Sequence[bytes],
        signatures: Sequence[bytes],
    ) -> List[bool]:
        raise NotImplementedError

    def verify_signatures_async(self, public_keys, digests, signatures):
        """Staged-dispatch seam: submit without blocking, returning a handle
        whose ``result()`` blocks until the verdicts are ready.  Backends
        with a real async queue (kernels queued on a CUDA stream) override
        this so the device computes while the host packs the next
        batch; the default defers the synchronous path to ``result()`` —
        host backends have no device queue to exploit, and the pipeline's
        fetch stage runs them on concurrent executor threads anyway."""
        return DeferredDispatch(
            self.verify_signatures, public_keys, digests, signatures
        )

    def warmup(self) -> None:
        """Optional: pay one-time costs (tracing, compilation) before the
        first real batch arrives.  Called from a background thread at node
        boot; default no-op."""

    def resolved_backend(self) -> str:
        """The platform this verifier's dispatches ACTUALLY land on.  Host
        oracles are "cpu"; accelerator backends override with their device
        type."""
        return "cpu"

    def padded_batch(self, n: int) -> int:
        """Device lanes an ``n``-signature dispatch actually occupies; the
        host paths pay no padding.  Telemetry only (padding waste =
        ``padded_batch(n) - n``)."""
        return n


class CpuSignatureVerifier(SignatureVerifier):
    """The CPU oracle path (cryptography/OpenSSL, or the pure-Python RFC 8032
    fallback) — reference behavior (crypto.rs:174-189), also the correctness
    baseline for the CUDA kernels."""

    def verify_signatures(self, public_keys, digests, signatures):
        from . import crypto

        out = []
        for pk, digest, sig in zip(public_keys, digests, signatures):
            out.append(crypto.PublicKey(pk).verify(sig, digest))
        return out



class TorchSignatureVerifier(SignatureVerifier):
    """The CUDA kernels (ops/ed25519_cuda.py) behind the fused raw-bytes path.

    With ``committee_keys`` the signer set is known: the keys and their
    combs live on the device in a ``KeyTable``, a signature rides as an
    index (26 words on the wire instead of 33), and every chunk of committee
    keys takes the keyed kernel, one key per lane; a key outside the table
    rides the generic kernel.  ``device`` defaults to ``cuda``
    and raises without a card; ``device="cpu"`` runs the kernels' plain
    PyTorch versions.

    ``mesh="auto"`` shards each batch over the host's cards (parallel/mesh.py)
    when more than one is attached; one card, or ``device="cpu"``, dispatches
    on that device alone.  Pass an explicit ``parallel.mesh.Mesh`` or
    ``None`` to override."""

    def __init__(self, mesh="auto", committee_keys=None, device=None) -> None:
        from .ops.ed25519 import KeyTable, resolve_device

        self._mesh = mesh
        self.device = resolve_device(device)
        self._table = None
        if committee_keys:
            self._table = KeyTable(list(committee_keys), device=self.device)

    def _resolve_mesh(self):
        if self._mesh == "auto":
            import torch

            from .parallel.mesh import make_mesh

            # The largest power-of-two prefix of the cards: the bucket shapes
            # (256 ... 16,384) shard evenly only over power-of-two meshes.
            n = torch.cuda.device_count() if self.device.type == "cuda" else 1
            pow2 = 1 << (n.bit_length() - 1)
            self._mesh = make_mesh(pow2) if pow2 > 1 else None
        return self._mesh

    def warmup(self) -> None:
        """Pay one-time costs (the kernels' build, the comb upload, the key
        combs) before the first real batch: a one-unknown-key batch and, with
        a committee table, a one-signature-per-key batch.  Its launches
        count also as warm-up launches (``ed25519_cuda.warming``)."""
        from .ops.ed25519_cuda import warming

        dummy = bytes(32)
        with warming():
            self.verify_signatures([dummy], [dummy], [bytes(64)])
            if self._table is not None:
                self._table.neg_combs51()
                if len(self._table) > 1:
                    pks = list(self._table._keys)
                    self.verify_signatures(pks, [dummy] * len(pks), [bytes(64)] * len(pks))

    def resolved_backend(self) -> str:
        """The torch device type the dispatches land on ("cuda" or "cpu")."""
        return self.device.type

    def padded_batch(self, n: int) -> int:
        """Lanes dispatched for n signatures under the fixed bucket shapes."""
        from .ops.ed25519 import iter_buckets

        return sum(bucket for _, _, bucket in iter_buckets(n))

    def verify_signatures_async(self, public_keys, digests, signatures):
        """Pack on the calling thread and queue every bucket chunk's kernels
        on the device streams; ``result()`` pays one copy back per device."""
        mesh = self._resolve_mesh()
        # The sharded kernels take 32-byte messages (block digests); other
        # lengths hash on the host on one device, so the result never
        # depends on the device count.
        if mesh is not None and all(len(d) == 32 for d in digests):
            from .parallel import mesh as M

            if self._table is not None:
                return M.dispatch_sharded_indexed(mesh, self._table, public_keys, digests, signatures)
            return M.dispatch_sharded_fused(mesh, public_keys, digests, signatures)
        from .ops import ed25519

        # A traced collector dispatch records its host phases (_SUBMITTING).
        phases = getattr(_SUBMITTING, "phases", None)
        if self._table is not None:
            return ed25519.dispatch_batch_table(self._table, public_keys, digests, signatures,
                                                phases)
        return ed25519.dispatch_batch(public_keys, digests, signatures, self.device, phases)

    def verify_signatures(self, public_keys, digests, signatures):
        return list(self.verify_signatures_async(public_keys, digests, signatures).result())


def _update_ema(current: float, sample: float, outlier_s: float) -> float:
    """EMA with outlier rejection: samples past ``outlier_s`` (one-time
    kernel builds) never enter; the first sample seeds."""
    if sample >= outlier_s:
        return current
    return sample if current == 0.0 else 0.8 * current + 0.2 * sample


class HybridSignatureVerifier(SignatureVerifier):
    """Route each batch to the CPU oracle or the accelerator backend by
    MEASURED cost.  The port's copy of the JAX package's router; the
    accelerator route is ``TorchSignatureVerifier`` (the GPU), and the
    attribute names keep the JAX package's ``tpu`` so one test drives both.

    The accelerator's cost model has TWO measured parameters, not one:

    * ``tpu_dispatch_s`` — the fixed per-dispatch cost, seeded by a
      1-signature probe after warmup;
    * ``tpu_per_sig_s`` — the marginal per-signature cost, learned from
      live accelerator-routed dispatches (``max(0, (t - fixed) / n)``).

    A fixed-only model routes saturation batches to "accelerators" that are
    actually slower per signature than the oracle (a backend that runs on
    the host, seconds per dispatch).  Routing per batch of size n:

    1. ``tpu_time(n) <= cpu_time(n)``       -> TPU (genuinely faster);
    2. ``cpu_time(n) > MAX_CPU_BUDGET_S``   -> TPU **iff**
       ``tpu_time(n) <= MAX_OFFLOAD_LATENCY_S`` — offloading frees the
       host core for the engine (worth paying bounded extra latency on an
       engine-bound fleet), but never to a backend whose turnaround would
       itself stall consensus;
    3. otherwise                            -> CPU.
    """

    DEFAULT_THRESHOLD = 32  # n-based routing until both sides are seeded
    MAX_CPU_BUDGET_S = 0.010  # max host time one CPU-routed batch may take
    # Offload-to-free-the-core is only sane when the accelerator turnaround
    # is itself consensus-compatible: a remote chip (~150 ms) qualifies, a
    # backend running on the host (seconds per dispatch) must not.
    MAX_OFFLOAD_LATENCY_S = 0.5
    EMA_OUTLIER_S = 5.0  # ignore one-time kernel-build stalls
    # Circuit breaker over the accelerator route: a dead backend (verifier
    # service restart, tunnel outage) degrades to the CPU oracle instead of
    # crashing the dispatch thread; re-probes use jittered exponential
    # backoff so a fleet that lost ONE shared service never re-probes it in
    # lockstep.  Only transport/timeout failures trip it — a
    # VerificationError-shaped rejection is a verdict, not an outage, and a
    # kernel that fails to build or load raises ops.cuda_build.CudaBuildError
    # (a RuntimeError), which propagates.
    BREAKER_EXCEPTIONS = (ConnectionError, TimeoutError, OSError)
    BREAKER_BASE_BACKOFF_S = 1.0
    BREAKER_MAX_BACKOFF_S = 30.0
    # Advertised backends with no accelerator behind them (the verifier
    # service's HELLO_OK, verifier_service.py): a service running on one of
    # these has nothing to offload TO — routing pins to the in-process oracle
    # until a re-HELLO probe sees an upgrade.  In-process backends advertise
    # nothing, so the pin stays dormant.
    CPU_ONLY_BACKENDS = frozenset({"cpu"})

    def __init__(
        self,
        tpu: Optional[SignatureVerifier] = None,
        cpu: Optional[SignatureVerifier] = None,
        threshold: Optional[int] = None,
        metrics=None,
    ) -> None:
        self.tpu = tpu or TorchSignatureVerifier()
        self.cpu = cpu or CpuSignatureVerifier()
        self._fixed_threshold = threshold
        self.metrics = metrics
        self.cpu_per_sig_s = 0.0
        self.tpu_dispatch_s = 0.0  # fixed component
        self.tpu_per_sig_s = 0.0  # marginal component
        # EMA read-modify-writes happen from executor threads; serialize them.
        self._ema_lock = threading.Lock()
        # Breaker state shares _ema_lock (same writer threads, same cadence).
        # backoff == 0.0 means closed; while open, dispatches fall back to
        # the CPU oracle until the probe deadline passes.  _breaker_probing
        # keeps the probe EXCLUSIVE even when it outlives the backoff
        # interval (a hung service blocks the probe thread for the whole
        # dispatch timeout; new windows must not admit more victims).
        self._breaker_backoff_s = 0.0
        self._breaker_open_until = 0.0
        self._breaker_probing = False
        # Trip generation: with several dispatches in flight, a PRE-outage
        # success can surface at fetch AFTER a newer failure tripped the
        # circuit — it must not re-close it (see result()).
        self._breaker_gen = 0
        self._breaker_rng = random.Random(0x0B7EA6E5)
        self._breaker_clock = time.monotonic  # injectable for tests
        # Backend pin (shares _ema_lock and the breaker's probe-exclusivity
        # flag): while the remote side advertises a CPU-only backend, every
        # batch short-circuits to the in-process oracle and a low-frequency
        # re-HELLO probe (jittered exponential backoff, same schedule
        # constants as the breaker) watches for an accelerator upgrade.
        self._pinned_backend: Optional[str] = None
        self._pin_backoff_s = 0.0
        self._pin_next_probe_t = 0.0
        # Routing label of the dispatch that ran in THIS thread: the batching
        # collector reads it right after verify_signatures returns, in the
        # same executor thread, so thread-local storage is exactly the
        # lifetime needed — a concurrent flush routed the other way cannot
        # overwrite it (it writes its own thread's slot).
        self._tls = threading.local()

    @property
    def backend_label(self) -> str:
        return getattr(self._tls, "label", "hybrid")

    @property
    def dispatch_padded(self) -> Optional[int]:
        """Padded lane count of the dispatch that ran in THIS thread (same
        thread-local lifetime as ``backend_label``).  Recorded at dispatch
        time because re-deriving the route afterwards can disagree: the
        dispatch itself updates the EMA cost model, so near the routing
        crossover ``padded_batch`` would attribute the waste to the wrong
        route — exactly the drift regime this telemetry exists to debug."""
        return getattr(self._tls, "padded", None)

    def _tpu_time(self, n: int) -> float:
        return self.tpu_dispatch_s + n * self.tpu_per_sig_s

    def _route_to_tpu(self, n: int) -> bool:
        if self._fixed_threshold is not None:
            return n >= self._fixed_threshold
        if not (self.cpu_per_sig_s > 0.0 and self.tpu_dispatch_s > 0.0):
            return n >= self.DEFAULT_THRESHOLD
        cpu_t = n * self.cpu_per_sig_s
        tpu_t = self._tpu_time(n)
        if tpu_t <= cpu_t:
            return True
        return (
            cpu_t > self.MAX_CPU_BUDGET_S
            and tpu_t <= self.MAX_OFFLOAD_LATENCY_S
        )

    # threshold() sentinel: no batch size is currently routed to the
    # accelerator (degraded backend).
    NEVER = 1 << 32

    def threshold(self) -> int:
        """Smallest batch size currently routed to the accelerator
        (introspection/logging; routing itself is per-batch).  Closed form
        over the two linear cost models — routes agree with
        ``_route_to_tpu`` by construction."""
        import math

        if self._pinned_backend is not None:
            return self.NEVER  # CPU-only backend: nothing to offload to
        if self._fixed_threshold is not None:
            return self._fixed_threshold
        if not (self.cpu_per_sig_s > 0.0 and self.tpu_dispatch_s > 0.0):
            return self.DEFAULT_THRESHOLD
        best = self.NEVER
        # Rule 1: tpu genuinely faster from the speed crossover on.
        denom = self.cpu_per_sig_s - self.tpu_per_sig_s
        if denom > 0.0:
            best = max(1, math.ceil(self.tpu_dispatch_s / denom))
        # Rule 2: smallest over-budget batch, if the offload is sane there.
        n_budget = int(self.MAX_CPU_BUDGET_S / self.cpu_per_sig_s) + 1
        if self._tpu_time(n_budget) <= self.MAX_OFFLOAD_LATENCY_S:
            best = min(best, n_budget)
        return best

    # -- circuit breaker --

    @property
    def breaker_open(self) -> bool:
        return self._breaker_backoff_s > 0.0

    def _admit_accelerator(self) -> Tuple[bool, bool]:
        """(blocked, is_probe).  Blocked while the breaker holds the route
        closed.  Once the probe deadline passes, exactly ONE dispatch gets
        through as the probe — the ``_breaker_probing`` flag (not a pushed
        deadline) keeps it exclusive even when the probe outlives the
        backoff interval.  ``is_probe`` tells the admitted dispatch it OWNS
        that flag: only the owner may release it on a non-verdict exit
        (abandon, propagating non-breaker exception) — an unconditional
        clear could release a DIFFERENT in-flight probe's exclusivity."""
        with self._ema_lock:
            if self._breaker_backoff_s == 0.0:
                return False, False
            now = self._breaker_clock()
            if self._breaker_probing or now < self._breaker_open_until:
                return True, False
            self._breaker_probing = True
            return False, True

    def _trip_breaker(self, exc: BaseException,
                      owns_probe: bool = False) -> None:
        """Open (or widen) the circuit.  ``owns_probe`` mirrors the
        ``is_probe`` admission flag: only the dispatch that OWNS the
        exclusive probe slot may release it on failure — a pre-outage
        straggler failing at fetch while a probe hangs must not readmit
        victims behind the hung probe's back."""
        now = self._breaker_clock()
        with self._ema_lock:
            self._breaker_gen += 1
            if owns_probe:
                self._breaker_probing = False
            prev = self._breaker_backoff_s
            backoff = (
                self.BREAKER_BASE_BACKOFF_S
                if prev == 0.0
                else min(prev * 2.0, self.BREAKER_MAX_BACKOFF_S)
            )
            self._breaker_backoff_s = backoff
            self._breaker_open_until = now + jittered_backoff(
                backoff, self._breaker_rng
            )
        log.warning(
            "accelerator verify path failed (%r): circuit open, degrading to "
            "the CPU oracle; next probe in ~%.1f s", exc, backoff,
        )

    def _close_breaker(self, expected_gen: Optional[int] = None) -> bool:
        """Close the circuit.  With ``expected_gen``, close only while the
        breaker generation still matches — compared under the lock, so a
        success surfacing at fetch can never erase a trip that raced it
        between the caller's generation read and the close."""
        with self._ema_lock:
            if (expected_gen is not None
                    and expected_gen != self._breaker_gen):
                return False
            was_open = self._breaker_backoff_s > 0.0
            self._breaker_backoff_s = 0.0
            self._breaker_probing = False
        if was_open:
            log.info("accelerator verify path recovered: circuit closed")
        return True

    def _clear_probe(self) -> None:
        """Release probe exclusivity when the dispatch neither succeeded nor
        counted as an outage (a propagating non-breaker exception) — a stuck
        flag would otherwise hold the breaker open forever."""
        with self._ema_lock:
            self._breaker_probing = False

    # -- backend pin (short-circuit routing) --

    @property
    def pinned_backend(self) -> Optional[str]:
        """The CPU-only backend routing is currently pinned against, or
        None when offload is open (introspection/tests)."""
        return self._pinned_backend

    def _sync_pin_with_advertisement(self) -> None:
        """Cheap per-batch attr read: a mid-run reconnect (service restart)
        can change the remote client's advertised backend between probes —
        a CPU-only advertisement pins routing the moment any thread sees
        it, not a probe interval later."""
        adv = getattr(self.tpu, "advertised_backend", None)
        if adv in self.CPU_ONLY_BACKENDS and self._pinned_backend is None:
            self._pin_routing(adv)

    def _pin_routing(self, backend: str) -> None:
        now = self._breaker_clock()
        with self._ema_lock:
            if self._pinned_backend is not None:
                return
            self._pinned_backend = backend
            self._pin_backoff_s = self.BREAKER_BASE_BACKOFF_S
            self._pin_next_probe_t = now + jittered_backoff(
                self._pin_backoff_s, self._breaker_rng
            )
        log.info(
            "verifier backend %r has no accelerator: routing pinned to the "
            "in-process oracle (re-HELLO upgrade probe in ~%.1f s)",
            backend, self.BREAKER_BASE_BACKOFF_S,
        )

    def _admit_pin_probe(self) -> bool:
        """At most one re-HELLO upgrade probe at a time, past the backoff
        deadline — the ``_breaker_probing`` flag is shared with
        ``_admit_accelerator`` so a hung HELLO admits no further probes and
        never races a breaker probe for the same exclusivity."""
        with self._ema_lock:
            if self._pinned_backend is None:
                return False
            now = self._breaker_clock()
            if self._breaker_probing or now < self._pin_next_probe_t:
                return False
            self._breaker_probing = True
            return True

    def _finish_pin_probe(self, backend: Optional[str], calibration,
                          probed: bool = False) -> None:
        """Probe outcome.  With ``probed`` (the re-HELLO round-trip actually
        completed): any answer that is not a CPU-only advertisement unpins —
        including NO advertisement (an older service replaced the one that
        pinned us; its platform is unknown, and unknown must never stay
        pinned — the same conservative default that refuses to pin in the
        first place), and a fresh calibration reseeds the cost model.
        Without ``probed`` (unreachable service, no rehello support, or an
        abandoned probe) the pin stands and the backoff doubles, decaying
        the steady-state probe cost to one HELLO per
        ``BREAKER_MAX_BACKOFF_S``."""
        now = self._breaker_clock()
        upgraded = probed and backend not in self.CPU_ONLY_BACKENDS
        with self._ema_lock:
            self._breaker_probing = False
            if upgraded:
                self._pinned_backend = None
                self._pin_backoff_s = 0.0
                if calibration is not None:
                    self.tpu_dispatch_s, self.tpu_per_sig_s = calibration
            else:
                self._pin_backoff_s = min(
                    self._pin_backoff_s * 2.0, self.BREAKER_MAX_BACKOFF_S
                )
                self._pin_next_probe_t = now + jittered_backoff(
                    self._pin_backoff_s, self._breaker_rng
                )
        if upgraded:
            log.info(
                "verifier service re-advertised backend %r: offload "
                "re-opened", backend,
            )

    def _reprobe_pin_and_verify(self, public_keys, digests, signatures, n):
        """Fetch-stage body of the probe-carrying batch: ONE re-HELLO round
        trip (never a verify frame), then the batch verifies on the oracle
        exactly as its window-mates did.  A service outage here is not an
        outage of the route in use — the pin already avoids the socket — so
        it only pushes the next probe out, never trips the breaker."""
        backend = calibration = None
        probed = False
        try:
            rehello = getattr(self.tpu, "rehello", None)
            if rehello is not None:
                backend, calibration = rehello()
                probed = True
        except VerifierProtocolError as exc:
            log.warning(
                "pin re-probe HELLO rejected (%r): staying on the oracle",
                exc,
            )
        except self.BREAKER_EXCEPTIONS as exc:
            log.debug(
                "pin re-probe HELLO failed (%r): staying on the oracle", exc
            )
        finally:
            self._finish_pin_probe(backend, calibration, probed=probed)
        return self._verify_cpu(public_keys, digests, signatures, n)

    def warmup(self) -> None:
        from . import crypto

        signer = crypto.Signer.dummy()
        digest = crypto.blake2b_256(b"hybrid-warmup")
        sig = signer.sign(digest)
        pk = signer.public_key.bytes
        # Accelerator cost model: prefer the BACKEND's own calibration (the
        # verifier service measures its warmed dispatch once and shares it
        # with every client over HELLO_OK) — N co-located validators each
        # probing a shared service would serialize N dispatches behind boot
        # contention.  A local backend without one gets the probe dispatch.
        # An unreachable backend (service not yet up, tunnel down) must not
        # kill the warmup thread: trip the breaker and boot on the oracle.
        provided = None
        try:
            self.tpu.warmup()  # kernel build, comb uploads
            calibrate = getattr(self.tpu, "dispatch_calibration", None)
            provided = calibrate() if calibrate is not None else None
            if provided is None:
                started = time.monotonic()
                self.tpu.verify_signatures([pk], [digest], [sig])
                # Real-backend boot calibration only: sims construct oracle
                # verifiers (chaos.py), so these EMAs keep their
                # deterministic __init__ defaults in virtual time.
                provided = (time.monotonic() - started, 0.0)  # lint: ignore[sim-taint]
        except self.BREAKER_EXCEPTIONS as exc:
            if isinstance(exc, VerifierProtocolError):
                raise  # misconfiguration, not an outage: fail fast
            self._trip_breaker(exc)
        # The warmup HELLO told us what actually answers behind the socket:
        # a CPU-only backend pins routing before the first real batch, so
        # even boot traffic never pays the socket round-trip for nothing.
        self._sync_pin_with_advertisement()
        started = time.monotonic()
        reps = 32
        self.cpu.verify_signatures([pk] * reps, [digest] * reps, [sig] * reps)
        # Same boot-calibration exemption as the card probe above.
        cpu_probe = (time.monotonic() - started) / reps  # lint: ignore[sim-taint]
        # Warmup runs on a background thread while live dispatches may
        # already be updating the EMAs from executor threads — the
        # calibration writes must join the same lock or a concurrent RMW
        # that read the pre-warmup value could land after and discard them.
        with self._ema_lock:
            if provided is not None:
                self.tpu_dispatch_s, self.tpu_per_sig_s = provided
            self.cpu_per_sig_s = cpu_probe
        log.info(
            "hybrid verifier calibrated: tpu %.1f ms fixed + %.1f µs/sig, "
            "cpu %.0f µs/sig -> tpu from batch %d",
            1e3 * self.tpu_dispatch_s,
            1e6 * self.tpu_per_sig_s,
            1e6 * self.cpu_per_sig_s,
            self.threshold(),
        )

    def _note_route(self, route: str, estimated_s: float, actual_s: float) -> None:
        """Router decision telemetry: which way the batch went, and how far
        the cost model's estimate was from the measured dispatch (a drifting
        estimate is the precursor of a misroute)."""
        if self.metrics is None:
            return
        self.metrics.verify_route_total.labels(route).inc()
        if estimated_s > 0.0:
            self.metrics.verify_route_estimate_error_s.observe(
                abs(actual_s - estimated_s)
            )

    def verify_signatures_async(self, public_keys, digests, signatures):
        """Staged routing: a TPU-routed batch submits through the backend's
        own async queue (kernels queued on the device streams) and returns an
        in-flight handle; a breaker failure AT FETCH degrades that one batch
        to the oracle inside ``result()`` — zero lost futures.  CPU-routed
        (and breaker-blocked) batches defer the oracle to the fetch stage
        unchanged."""
        n = len(signatures)
        if n == 0:
            return CompletedDispatch([])
        self._sync_pin_with_advertisement()
        if self._pinned_backend is not None:
            # Short-circuit: the service advertised a CPU-only backend, so
            # the batch completes wholly in-process — zero socket frames,
            # zero collector serialization toward the wire.  At most one
            # batch per backoff interval carries the re-HELLO upgrade probe
            # into its fetch stage (a HELLO frame, never a verify).
            if self.metrics is not None:
                self.metrics.verify_shortcircuit_total.labels(
                    "backend-cpu"
                ).inc()
            if self._admit_pin_probe():
                return _PinProbeDispatch(
                    self, public_keys, digests, signatures, n
                )
            return DeferredDispatch(
                self._verify_cpu, public_keys, digests, signatures, n
            )
        degraded = False
        breaker_blocked = False
        if self._route_to_tpu(n):
            blocked, is_probe = self._admit_accelerator()
            if blocked:
                # Circuit open: the route is held closed and the batch
                # never touches the socket (unlike a mid-dispatch failure
                # below, which may have sent frames before raising).
                degraded = True
                breaker_blocked = True
            else:
                # Captured BEFORE the submit: a trip racing the submission
                # means this dispatch's eventual success is ambiguous
                # evidence and must not close the circuit.
                gen = self._breaker_gen
                try:
                    handle = self.tpu.verify_signatures_async(
                        public_keys, digests, signatures
                    )
                except self.BREAKER_EXCEPTIONS as exc:
                    if isinstance(exc, VerifierProtocolError):
                        if is_probe:
                            self._clear_probe()
                        raise
                    self._trip_breaker(exc, owns_probe=is_probe)
                    degraded = True
                except BaseException:
                    if is_probe:
                        self._clear_probe()
                    raise
                else:
                    return _HybridTpuDispatch(
                        self, handle, public_keys, digests, signatures, n,
                        is_probe, gen,
                    )
        if self.metrics is not None:
            if degraded:
                self.metrics.verifier_fallback_total.inc()
                if breaker_blocked:
                    self.metrics.verify_shortcircuit_total.labels(
                        "breaker"
                    ).inc()
            else:
                # The cost-model router decided against offloading: the
                # batch must never touch the socket — and doesn't (the
                # oracle runs in-process at the fetch stage).
                self.metrics.verify_shortcircuit_total.labels("router").inc()
        return DeferredDispatch(
            self._verify_cpu, public_keys, digests, signatures, n
        )

    def verify_signatures(self, public_keys, digests, signatures):
        """One routing/breaker implementation for both call shapes: the
        sync path is the async path fetched immediately (submit-time breaker
        handling in ``verify_signatures_async``, fetch-time in
        ``_HybridTpuDispatch.result`` — keeping a second copy in lockstep is
        how probe-ownership bugs breed)."""
        return self.verify_signatures_async(
            public_keys, digests, signatures
        ).result()

    def _verify_cpu(self, public_keys, digests, signatures, n):
        estimated = n * self.cpu_per_sig_s
        started = time.monotonic()
        out = self.cpu.verify_signatures(public_keys, digests, signatures)
        elapsed = time.monotonic() - started
        sample = elapsed / n
        with self._ema_lock:
            self.cpu_per_sig_s = _update_ema(
                self.cpu_per_sig_s, sample, self.EMA_OUTLIER_S
            )
        self._note_route("cpu", estimated, elapsed)
        self._tls.label = "hybrid-cpu"
        self._tls.padded = n  # host oracle: no padding lanes
        return out

    def _absorb_tpu_sample(self, sample: float, n: int) -> None:
        """Fold one measured TPU dispatch into the two-parameter cost model.

        The residual against the CURRENT model is split 50/50 between the
        fixed and marginal components: attributing the FULL
        residual to both in the same update — each computed against the
        other's pre-update value — let one slow dispatch inflate the summed
        model by ~double the residual and wrongly veto the rule-2 saturation
        offload until the EMAs decayed.  With the split, the summed model
        moves by exactly the residual; observations at varied batch sizes
        still disambiguate fixed from marginal over time, and the fixed
        component can still rise (a tunnel settling slower than its warmup
        probe is not misattributed wholesale to per-signature cost).
        """
        if sample >= self.EMA_OUTLIER_S:
            return
        with self._ema_lock:
            residual = sample - (self.tpu_dispatch_s + n * self.tpu_per_sig_s)
            implied_fixed = max(0.0, self.tpu_dispatch_s + 0.5 * residual)
            implied_marginal = max(
                0.0, self.tpu_per_sig_s + 0.5 * residual / n
            )
            self.tpu_dispatch_s = _update_ema(
                self.tpu_dispatch_s, implied_fixed, self.EMA_OUTLIER_S
            )
            self.tpu_per_sig_s = _update_ema(
                self.tpu_per_sig_s, implied_marginal, self.EMA_OUTLIER_S
            )

class _PinProbeDispatch:
    """The pinned route's probe-carrying batch: ``result()`` runs the
    re-HELLO + oracle verify on the fetch stage's executor thread.  The
    handle OWNS the shared probe-exclusivity flag from admission, so a
    flush cancelled between submit and fetch must release it via
    ``abandon()`` — a bare DeferredDispatch here would strand the flag
    forever (no further pin probes, and the breaker's own probes blocked),
    the leak the abandon protocol exists to prevent."""

    __slots__ = ("_hybrid", "_args")

    def __init__(self, hybrid, public_keys, digests, signatures, n) -> None:
        self._hybrid = hybrid
        self._args = (public_keys, digests, signatures, n)

    def result(self) -> List[bool]:
        return self._hybrid._reprobe_pin_and_verify(*self._args)

    def abandon(self) -> None:
        """Released without fetching: not a completed probe (``probed``
        stays False), so the pin stands and only the backoff advances."""
        self._hybrid._finish_pin_probe(None, None)


class _HybridTpuDispatch:
    """An in-flight TPU-routed batch of the hybrid verifier.

    ``result()`` runs on the fetch stage's executor thread, so the breaker
    bookkeeping, cost-model update, and the thread-local backend label all
    land exactly where the sync path put them — the collector reads
    ``backend_label``/``dispatch_padded`` right after ``result()`` in the
    same thread.  A transport/timeout failure surfacing at fetch trips the
    breaker and verifies THIS batch on the oracle: a backend dying
    mid-pipeline loses zero futures."""

    __slots__ = ("_hybrid", "_handle", "_args", "_n", "_estimated",
                 "_padded", "_started", "_is_probe", "_gen")

    def __init__(self, hybrid, handle, public_keys, digests, signatures,
                 n, is_probe: bool = False, gen: int = 0) -> None:
        self._hybrid = hybrid
        self._handle = handle
        self._args = (public_keys, digests, signatures)
        self._n = n
        self._estimated = hybrid._tpu_time(n)
        self._padded = hybrid.tpu.padded_batch(n)
        self._started = time.monotonic()
        self._is_probe = is_probe
        self._gen = gen

    def result(self) -> List[bool]:
        h = self._hybrid
        try:
            out = self._handle.result()
        except h.BREAKER_EXCEPTIONS as exc:
            if isinstance(exc, VerifierProtocolError):
                if self._is_probe:
                    h._clear_probe()
                raise
            h._trip_breaker(exc, owns_probe=self._is_probe)
            if h.metrics is not None:
                h.metrics.verifier_fallback_total.inc()
            return h._verify_cpu(*self._args, self._n)
        except BaseException:
            if self._is_probe:
                h._clear_probe()
            raise
        # Submit-to-fetch wall time: under pipelining this is the batch's
        # actual turnaround (what the router's model predicts), queueing
        # included; the EMA's outlier gate still drops compile stalls.
        sample = time.monotonic() - self._started
        if not h._close_breaker(expected_gen=self._gen) and self._is_probe:
            # A newer trip owns the circuit: this probe's success is stale
            # evidence — its only remaining obligation is releasing the
            # exclusive probe slot it still holds.
            h._clear_probe()
        h._note_route("tpu", self._estimated, sample)
        h._absorb_tpu_sample(sample, self._n)
        h._tls.label = "hybrid-tpu"
        h._tls.padded = self._padded
        return list(out)

    def abandon(self) -> None:
        """Release per-dispatch state without fetching (the flush was
        cancelled): if THIS dispatch owns the breaker's exclusive probe
        flag it must not stay stuck — only ``result()`` would otherwise
        clear it — and the inner handle may hold its own releasable state.
        A non-probe dispatch touches nothing (clearing unconditionally
        could release a concurrent probe's exclusivity)."""
        if self._is_probe:
            self._hybrid._clear_probe()
        inner = getattr(self._handle, "abandon", None)
        if inner is not None:
            inner()


async def aggregate_verify(
    blocks: Sequence[StatementBlock],
    committee: Committee,
    direct_verify,
    count=None,
    prior_endorsers=None,
    defer_unresolved: bool = False,
) -> List[Optional[bool]]:
    """The threshold-aggregate acceptance rule over one batch of blocks
    (shared by the frame-level ``ThresholdAggregateVerifier`` and the
    collector-level aggregate mode of ``BatchedSignatureVerifier``).

    ``direct_verify(sub_blocks) -> List[bool]`` is the inner signature check
    (awaitable); ``count(aggregated, direct)`` is an optional accounting
    callback.  ``prior_endorsers(ref) -> set[AuthorityIndex]`` optionally
    supplies authors of PREVIOUSLY ACCEPTED blocks that include ``ref``
    (every accepted block was itself signature-verified or quorum-endorsed,
    so its endorsement carries inductively) — this is what makes the rule
    bite during catch-up, where peers' own-block streams run at different
    round offsets and a block's verified children usually arrived earlier
    via a faster stream.  See ``ThresholdAggregateVerifier`` and
    ``docs/aggregate-verification.md`` for the safety argument: acceptance
    chains are well-founded and terminate at directly verified signatures.

    Dispatch shape: one frontier dispatch, then the descending-round
    cascade accepts interiors off those results with NO further dispatch.  Blocks whose endorsement
    fell short once non-accepted endorsers were excluded ("unresolved"):

    * ``defer_unresolved=False`` (frame-level wrapper): a second direct
      dispatch resolves them here.  Correct, but SERIALIZED behind the
      frontier dispatch — on a remote accelerator (~100 ms/round-trip) the
      second trip halves flush cadence exactly where aggregation was meant
      to help.
    * ``defer_unresolved=True`` (the batching collector's deployed mode):
      their slots return ``None`` and the collector folds them into the
      NEXT flush window, where they are either endorsed by newly arrived
      children or dispatched as ordinary frontier — every flush pays
      exactly one round-trip, same as the plain verifier.  The collector
      force-dispatches a block on its SECOND deferral: otherwise a
      Byzantine author could park a forged block in "maybe" forever by
      minting fresh structure-valid endorsers each window (liveness, not
      safety — acceptance still requires a quorum of ACCEPTED endorsers).
    """
    n = len(blocks)
    if count is None:
        count = lambda aggregated, direct: None  # noqa: E731
    if n == 0:
        return []
    if n == 1 and prior_endorsers is None:
        count(0, n)
        return list(await direct_verify(list(blocks)))
    index_of = {b.reference: i for i, b in enumerate(blocks)}
    # endorsers[i] = indexes of in-batch blocks that include block i.
    endorsers: List[List[int]] = [[] for _ in range(n)]
    for j, b in enumerate(blocks):
        for ref in b.includes:
            i = index_of.get(ref)
            if i is not None:
                endorsers[i].append(j)

    quorum = committee.quorum_threshold()

    def endorsement_stake(i, accepted_flags) -> int:
        seen = (
            set(prior_endorsers(blocks[i].reference))
            if prior_endorsers is not None
            else set()
        )
        stake = sum(committee.get_stake(a) for a in seen)
        for j in endorsers[i]:
            if accepted_flags[j] is not True:
                continue
            author = blocks[j].author()
            if author in seen:
                continue
            seen.add(author)
            stake += committee.get_stake(author)
        return stake

    # Frontier = blocks that cannot possibly reach quorum endorsement
    # even if every endorser were accepted.
    maybe: List[Optional[bool]] = [None] * n
    all_true = [True] * n
    frontier = [i for i in range(n) if endorsement_stake(i, all_true) < quorum]
    frontier_set = set(frontier)
    # Descending claimed-round order: honest endorsers sit in strictly
    # higher rounds than the blocks they include, so an endorser's fate is
    # known by the time its endorsee is evaluated.  Rounds are attacker-
    # claimed, but a mis-ordered (forged) endorser merely evaluates as
    # not-yet-accepted (False) — never as accepted (see
    # docs/aggregate-verification.md, well-foundedness).
    order = sorted(
        (i for i in range(n) if i not in frontier_set),
        key=lambda i: -blocks[i].round(),
    )
    direct = await direct_verify([blocks[i] for i in frontier])
    for i, ok in zip(frontier, direct):
        maybe[i] = bool(ok)
    count(0, len(frontier))
    for i in order:
        maybe[i] = endorsement_stake(i, maybe) >= quorum
        if maybe[i]:
            count(1, 0)
    unresolved = [i for i in order if maybe[i] is False]
    if unresolved:
        if defer_unresolved:
            # The caller folds these into its next flush window — no second
            # serialized dispatch on this one.
            for i in unresolved:
                maybe[i] = None
            return list(maybe)
        # Endorsement fell short once non-accepted endorsers were excluded:
        # these still deserve a direct check rather than a blanket reject.
        second = await direct_verify([blocks[i] for i in unresolved])
        count(0, len(unresolved))
        for i, ok in zip(unresolved, second):
            maybe[i] = bool(ok)
    return [bool(v) for v in maybe]


class ThresholdAggregateVerifier(BlockVerifier):
    """Threshold-aggregate verification (BASELINE config #5's technique).

    Exploits the digest/signature layering (crypto.rs:77-84): a block's
    reference digest is computed over its full serialization INCLUDING the
    signature, and honest validators only include blocks they verified.  So
    when blocks signed by a quorum (2f+1 stake, hence >= f+1 honest) of
    distinct authorities reference block B, B's authenticity is already
    certified by the quorum — its signature need not be re-checked here.

    Applied at batch granularity on the receive path: within one incoming
    batch (catch-up and sync deliver hundreds of blocks spanning many
    rounds), only the non-endorsed FRONTIER is signature-verified through
    the inner verifier (one accelerator dispatch); interior blocks are accepted when
    a quorum of distinct accepted in-batch endorsers references them.
    Acceptance is evaluated in descending-round order, so every acceptance
    chain terminates at directly verified frontier signatures — a forged
    interior block needs 2f+1 distinct accepted endorsers, which exceeds the
    fault model.

    Blocks that do not reach quorum endorsement (including every singleton
    steady-state delivery) go through the inner verifier unchanged.
    """

    def __init__(self, committee: Committee, inner: BlockVerifier,
                 metrics=None) -> None:
        self.committee = committee
        self.inner = inner
        self.metrics = metrics
        # Plain counters for tests; scrapeable via verified_signatures_total
        # {backend="aggregate"} when metrics are wired.
        self.aggregated_total = 0
        self.direct_total = 0

    def _count(self, aggregated: int, direct: int) -> None:
        self.aggregated_total += aggregated
        self.direct_total += direct
        if self.metrics is not None:
            if aggregated:
                self.metrics.verified_signatures_total.labels(
                    "aggregate", "skipped"
                ).inc(aggregated)
            if direct:
                self.metrics.verified_signatures_total.labels(
                    "aggregate", "direct"
                ).inc(direct)

    async def verify(self, block: StatementBlock) -> None:
        await self.inner.verify(block)

    async def verify_blocks(self, blocks: Sequence[StatementBlock]) -> List[bool]:
        return await aggregate_verify(
            blocks, self.committee, self.inner.verify_blocks, self._count
        )

    def note_committee(self, committee: Committee) -> None:
        """Quorum endorsement is stake-weighted: follow the epoch's stakes."""
        self.committee = committee
        note = getattr(self.inner, "note_committee", None)
        if note is not None:
            note(committee)


def _observe_orphan(fut) -> None:
    """Retrieve an orphaned executor future's exception so a backend crash
    after the awaiting flush was cancelled is logged, not swallowed into an
    'exception was never retrieved' warning at shutdown."""
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        log.warning("orphaned verify dispatch failed after cancel: %r", exc)


def _abandon_dispatch(fut) -> None:
    """Dispose a submitted-but-never-fetched dispatch handle (``fut`` is the
    submit's ``_timed_call`` future).

    Handles that hold releasable state expose ``abandon()``; plain handles
    (completed/deferred/device dispatches) need nothing.  A submit that
    RAISED already cleaned up after itself (the hybrid clears its probe, the
    remote client discards its connection)."""
    if fut.cancelled() or fut.exception() is not None:
        return
    abandon = getattr(fut.result()[0], "abandon", None)
    if abandon is None:
        return
    try:
        abandon()
    except Exception:  # noqa: BLE001 - best-effort cleanup on shutdown
        log.exception("abandoning an in-flight verify dispatch failed")


def _timed_call(fn, *args):
    """``fn(*args)`` in an executor thread, timed there: ``(result, start,
    end, thread CPU seconds)``.  Start and end are ``time.monotonic()``, the
    runtime clock off the simulator, so they sit on the loop's timeline."""
    start = time.monotonic()
    cpu = thread_time()
    out = fn(*args)
    return out, start, time.monotonic(), thread_time() - cpu


class _FlushPhases:
    """The host phases of one traced collector dispatch, as the backend
    marks them: ``(span name, start, end, thread CPU seconds)``, each from
    the previous mark (the first from ``start``, in the submitting thread)."""

    __slots__ = ("items", "_t", "_cpu")

    # The backend's phases (ops.ed25519.dispatch_batch) and their spans.
    SPANS = {"wire": "flush_wire", "upload": "flush_upload", "launch": "flush_launch"}

    def __init__(self) -> None:
        self.items: list = []
        self._t = self._cpu = 0.0

    def start(self) -> None:
        self._t, self._cpu = time.monotonic(), thread_time()

    def mark(self, phase: str) -> None:
        t, cpu = time.monotonic(), thread_time()
        self.items.append((self.SPANS[phase], self._t, t, cpu - self._cpu))
        self._t, self._cpu = t, cpu


# The phase recorder of the traced dispatch that this thread is submitting:
# the collector's seam into TorchSignatureVerifier, since every backend and
# wrapper shares verify_signatures_async's three-argument form.
_SUBMITTING = threading.local()


# The summed verify() arrival times (loop clock) of the blocks of the flush
# that the current task is dispatching, for verify_collector_wait_seconds_total.
_FLUSH_ARRIVED: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "flush_arrived", default=None)


class BatchedSignatureVerifier(BlockVerifier):
    """Deadline/size-triggered batching collector in front of a SignatureVerifier.

    Consensus wants low verification turnaround; the accelerator wants large
    batches.  Policy: a block's verification completes when either (a)
    ``max_batch`` items have accumulated, or (b) the collection window
    elapsed since the first pending item — whichever comes first.  The
    window is ``max_delay_s`` until a dispatch has been measured, then 20%
    of the dispatch-latency EMA clamped to [MIN, MAX]_ADAPTIVE_DELAY_S, and
    it shrinks further when arrivals are sparse (see ``_effective_delay_s``).

    Usable from any number of asyncio tasks (one per peer connection); the
    device dispatch runs in a worker thread so the event loop never blocks on
    the accelerator.

    With ``aggregate=True`` each flush goes through ``aggregate_verify``:
    quorum-endorsed interior blocks skip the signature dispatch and only the
    frontier pays (see ``_flush`` and ``_resolve_deferred``).
    """

    MAX_ADAPTIVE_DELAY_S = 0.1
    MIN_ADAPTIVE_DELAY_S = 0.0005
    EMA_OUTLIER_S = 5.0
    # Inter-arrival gaps are clamped here before entering the EMA: an idle
    # stretch means "low rate", but it must not drag the EMA so far that a
    # resuming burst needs minutes of samples to recover the window.
    ARRIVAL_GAP_CAP_S = 1.0
    # Ids of the dispatches whose flush_* spans a tracer records, unique in
    # the process.
    _flush_ids = itertools.count(1)

    def __init__(
        self,
        committee: Committee,
        verifier: SignatureVerifier,
        max_batch: int = 256,
        max_delay_s: float = 0.005,
        metrics=None,
        aggregate: bool = False,
        pipeline_depth: Optional[int] = None,
    ) -> None:
        self.committee = committee
        self.verifier = verifier
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        # Optional metrics.Metrics: the pipeline's stage seconds and
        # occupancy, the collection window, dispatch sizes, padding and
        # verdict counts.
        self.metrics = metrics
        # Staged dispatch window: several flushes may be in flight at once
        # (pack N+1 while N computes and N-1's results ride back), bounded
        # so a flooding peer cannot queue unbounded device work.
        self.pipeline = VerifyPipeline(
            depth=pipeline_depth, metrics=metrics,
            fixed_cost_fn=self._pipeline_fixed_cost,
        )
        # Collector-level threshold aggregation: one flush window pools
        # blocks from EVERY peer connection, so the batch spans authors —
        # exactly what quorum endorsement needs (a frame-level wrapper sees
        # one peer's own blocks, whose one author never reaches 2f+1
        # endorsement stake).  Interior quorum-endorsed blocks skip the
        # signature dispatch; only the frontier pays.
        self.aggregate = aggregate
        self.aggregated_total = 0
        self.direct_total = 0
        # Cross-flush endorsement index: ref -> authors of ACCEPTED blocks
        # that include it.  Catch-up streams from different peers run at
        # different round offsets, so a backlog block's quorum of verified
        # children has usually been accepted in EARLIER flushes.  Strictly
        # size-bounded with insertion-order (FIFO) eviction: rounds CLAIMED
        # by blocks are attacker-controlled, so neither the prune window nor
        # residency may key on them.
        self._endorsements: dict = {}
        # id(future) of entries deferred once (aggregate mode): the next
        # unresolved verdict force-dispatches instead of deferring again.
        self._deferred: set = set()
        self._pending: List[Tuple[StatementBlock, asyncio.Future]] = []
        # Sum of the pending blocks' arrival times (loop clock).
        self._pending_arrived = 0.0
        self._lock = threading.Lock()
        self._flush_task: Optional[asyncio.TimerHandle] = None
        # EMA of observed dispatch latency (wall clock); dispatches slower
        # than EMA_OUTLIER_S (one-time kernel builds) never enter it.
        self._dispatch_ema_s = 0.0
        # Arrival-rate EMA (loop clock): the collection window only pays off
        # when more arrivals are coming.
        self._arrival_gap_ema_s = 0.0
        self._last_arrival_t: Optional[float] = None

    def note_committee(self, committee: Committee) -> None:
        """Epoch switch: rebind the committee (per-author key lookups).  The
        verifier's KeyTable is indexed by the stable registry."""
        self.committee = committee

    def _pipeline_fixed_cost(self) -> float:
        """Fixed dispatch cost estimate for the adaptive pipeline depth: the
        hybrid router's measured fixed component when available, else the
        collector's own dispatch-latency EMA (unlocked snapshots)."""
        fixed = getattr(self.verifier, "tpu_dispatch_s", 0.0)
        return fixed if fixed > 0.0 else self._dispatch_ema_s

    def _effective_delay_s(self) -> float:
        """Collection window: 20% of the dispatch-latency EMA clamped to
        [MIN, MAX] (``max_delay_s`` before the first measurement), scaled
        down linearly when fewer than ~2 further arrivals are expected inside
        it.  ``max_batch`` arrivals flush at once regardless."""
        ema = self._dispatch_ema_s
        if ema == 0.0:
            ceiling = self.max_delay_s
        else:
            ceiling = max(
                self.MIN_ADAPTIVE_DELAY_S,
                min(0.2 * ema, self.MAX_ADAPTIVE_DELAY_S),
            )
        gap = self._arrival_gap_ema_s
        if gap <= 0.0:
            return ceiling
        expected = ceiling / gap  # further arrivals inside a full window
        if expected >= 2.0:
            return ceiling
        return max(self.MIN_ADAPTIVE_DELAY_S, ceiling * expected / 2.0)

    def _schedule_flush(self, loop) -> None:  # lint: holds[_lock]
        """Arm the window timer (caller holds ``self._lock``) and publish
        the chosen window."""
        delay = self._effective_delay_s()
        if self.metrics is not None:
            self.metrics.verify_collector_window_seconds.set(delay)
        self._flush_task = loop.call_later(
            delay, lambda: spawn_logged(self._flush(), log, name="verify-flush")
        )

    async def verify(self, block: StatementBlock) -> None:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        window = None
        now = loop.time()
        with self._lock:
            last = self._last_arrival_t
            self._last_arrival_t = now
            if last is not None:
                gap = min(now - last, self.ARRIVAL_GAP_CAP_S)
                # Same-tick arrivals sample as 0.0 ("dense"); a zero first
                # sample leaves the EMA unseeded rather than pinning it.
                self._arrival_gap_ema_s = (
                    gap
                    if self._arrival_gap_ema_s == 0.0
                    else 0.8 * self._arrival_gap_ema_s + 0.2 * gap
                )
            self._pending.append((block, future))
            self._pending_arrived += now
            if len(self._pending) >= self.max_batch:
                # Take the full window NOW and open a fresh one.
                window, arrived = self._pending, self._pending_arrived
                self._pending, self._pending_arrived = [], 0.0
                if self._flush_task is not None:
                    self._flush_task.cancel()
                    self._flush_task = None
            elif self._flush_task is None:
                self._schedule_flush(loop)
        if window is not None:
            # Flush as its own task: the prior window's dispatch may still be
            # in flight, and the bounded pipeline lets this pack overlap it.
            spawn_logged(self._flush(window, arrived), log, name="verify-flush")
        ok = await future
        if not ok:
            raise VerificationError(
                f"signature verification failed for {block.reference!r}"
            )

    def _submit_dispatch(self, pks, digests, sigs, phases: Optional[_FlushPhases] = None):
        """Device stage (executor thread): pack-to-wire + non-blocking
        submission through the backend's async seam; a traced dispatch's
        ``phases`` record the backend's host phases."""
        if phases is None:
            return self.verifier.verify_signatures_async(pks, digests, sigs)
        phases.start()
        _SUBMITTING.phases = phases
        try:
            return self.verifier.verify_signatures_async(pks, digests, sigs)
        finally:
            _SUBMITTING.phases = None

    def _dispatch_and_fetch(self, pks, digests, sigs):
        """Single-hop dispatch (simulation path): submit + fetch in one
        call on the loop thread."""
        return self._fetch_dispatch(
            self._submit_dispatch(pks, digests, sigs), len(sigs)
        )

    def _fetch_dispatch(self, handle, n):
        """Fetch stage (executor thread): block until the verdicts are
        ready.  The backend label and the padded lane count are read in THIS
        thread, right after ``result()``: the hybrid router records them
        thread-locally at fetch."""
        out = handle.result()
        label = getattr(self.verifier, "backend_label", type(self.verifier).__name__)
        padded = getattr(self.verifier, "dispatch_padded", None)
        if padded is None:
            padder = getattr(self.verifier, "padded_batch", None)
            padded = padder(n) if padder is not None else n
        return out, label, padded

    async def _direct(self, blocks) -> List[bool]:
        """One dispatch of ``blocks``' signatures through the pipeline.

        Off the simulator the dispatch also counts its executor queue waits
        (``stage="queue"``), the thread CPU of its stages, and, for a
        collector flush, the blocks' wait since ``verify()``; with a tracer
        it records its ``flush_*`` spans under one flush id.  Under the
        simulator none of that is recorded: a seeded sim's trace and samples
        stay the JAX package's."""
        if not blocks:
            return []
        loop = asyncio.get_running_loop()
        tracer = spans.active()
        metrics = self.metrics
        live = not is_simulated()
        flush_id = next(self._flush_ids) if live and tracer is not None else None
        phases = _FlushPhases() if flush_id is not None else None
        # -- pack stage (host, loop thread): key lookup + list building; the
        # numpy pack-to-wire happens inside the submit below.
        t_pack = tracer.now() if tracer is not None else 0.0
        pack_started = time.monotonic()
        pack_cpu = thread_time()
        pks = [self.committee.get_public_key(b.author()).bytes for b in blocks]
        digests = [b.signed_digest() for b in blocks]
        sigs = [b.signature for b in blocks]
        self.pipeline.note_stage(STAGE_PACK, time.monotonic() - pack_started)
        if live and metrics is not None:
            metrics.verify_pipeline_stage_cpu_seconds_total.labels(STAGE_PACK).inc(
                thread_time() - pack_cpu
            )
        flush = None
        if tracer is not None:
            flush = tracer.begin_flush([b.reference for b in blocks], t_pack)
        # -- bounded in-flight window, held from submission through fetch.
        async with self.pipeline.slot():
            t_dispatch = tracer.now() if tracer is not None else 0.0
            t_fetch = t_dispatch
            started = time.monotonic()
            if not live:
                # Inline (no executor hop) under the virtual-time simulator:
                # while a real thread works, the virtual clock leaps timers,
                # so any hop would make a seeded sim's commit schedule depend
                # on host load.  On the loop thread the virtual clock stands
                # still for the dispatch.  The single call has no separate
                # submit, so the device stage is an explicit zero and the
                # fetch stage carries the whole dispatch.
                out, label, padded = self._dispatch_and_fetch(pks, digests, sigs)
                self.pipeline.note_stage(STAGE_DEVICE, 0.0)
                self.pipeline.note_stage(STAGE_FETCH, time.monotonic() - started)
            else:
                arrived = _FLUSH_ARRIVED.get()
                if arrived is not None and metrics is not None:
                    metrics.verify_collector_wait_seconds_total.inc(
                        len(blocks) * loop.time() - arrived
                    )
                submit_fut = loop.run_in_executor(
                    None, _timed_call, self._submit_dispatch, pks, digests, sigs, phases
                )
                try:
                    handle, s0, s1, s_cpu = await asyncio.shield(submit_fut)
                except asyncio.CancelledError:
                    # Cancelled mid-submit (node shutdown): the shielded job
                    # still runs, and its handle may hold per-dispatch
                    # backend state (the breaker's exclusive probe flag) that
                    # only the fetch normally releases — dispose it the
                    # moment it lands.
                    submit_fut.add_done_callback(_abandon_dispatch)
                    raise
                self.pipeline.note_stage(STAGE_DEVICE, s1 - s0)
                if flush is not None:
                    t_fetch = tracer.now()
                    flush.device_done(t_dispatch, t_fetch)
                # Shielded for the same reason: an unshielded cancel can
                # cancel a QUEUED executor job, and then nothing consumes the
                # handle.
                fetch_queued = time.monotonic()
                fetch_fut = loop.run_in_executor(
                    None, _timed_call, self._fetch_dispatch, handle, len(sigs)
                )
                try:
                    (out, label, padded), f0, f1, f_cpu = await asyncio.shield(fetch_fut)
                except asyncio.CancelledError:
                    fetch_fut.add_done_callback(_observe_orphan)
                    raise
                self.pipeline.note_stage(STAGE_FETCH, f1 - f0)
                self.pipeline.note_stage(STAGE_QUEUE, (s0 - started) + (f0 - fetch_queued))
                if metrics is not None:
                    cpu = metrics.verify_pipeline_stage_cpu_seconds_total
                    cpu.labels(STAGE_DEVICE).inc(s_cpu)
                    cpu.labels(STAGE_FETCH).inc(f_cpu)
                if flush_id is not None:
                    args = {"flush": flush_id, "lanes": len(sigs)}
                    tracer.record_interval("flush_queue", started, s0, args)
                    for name, p0, p1, p_cpu in phases.items:
                        tracer.record_interval(name, p0, p1, {**args, "cpu_s": p_cpu})
                    tracer.record_interval("flush_fetch_queue", fetch_queued, f0, args)
                    tracer.record_interval("flush_fetch", f0, f1, {**args, "cpu_s": f_cpu})
        # Under the simulator the EMA stays unseeded: it is a wall-clock
        # measurement, and _effective_delay_s arms a virtual-time flush timer
        # from it, so folding it in would make a seeded sim's flush schedule
        # depend on host load.  Sims run the fixed max_delay_s window (the
        # arrival-gap term is loop-clocked and stays live).
        if live:
            with self._lock:
                self._dispatch_ema_s = _update_ema(
                    self._dispatch_ema_s, time.monotonic() - started, self.EMA_OUTLIER_S
                )
        if flush is not None:
            flush.done(t_fetch, t_dispatch, tracer.now(),
                       None if flush_id is None else {"flush": flush_id})
        if metrics is not None:
            metrics.verify_dispatch_batch_size.observe(len(sigs))
            # Padding waste: lanes the device computed beyond the real
            # signatures (bucket-shaped dispatches); host backends report n.
            metrics.verify_padding_wasted_total.labels(label).inc(
                max(0, padded - len(sigs))
            )
            accepted = sum(bool(ok) for ok in out)
            if accepted:
                metrics.verified_signatures_total.labels(label, "accepted").inc(accepted)
            if accepted < len(out):
                metrics.verified_signatures_total.labels(label, "rejected").inc(
                    len(out) - accepted
                )
        return out

    async def _flush(self, batch=None, arrived: Optional[float] = None) -> None:
        """Dispatch ``batch`` (default: the pending window); ``arrived`` is
        the sum of its blocks' ``verify()`` arrival times, for
        ``verify_collector_wait_seconds_total`` (not counted without it, nor
        in aggregate mode, whose dispatches hold part of a window)."""
        if batch is None:
            with self._lock:
                batch, arrived = self._pending, self._pending_arrived
                self._pending, self._pending_arrived = [], 0.0
                if self._flush_task is not None:
                    self._flush_task.cancel()
                    self._flush_task = None
        if not batch:
            return
        blocks = [b for b, _ in batch]
        try:
            if self.aggregate:
                results = await aggregate_verify(
                    blocks, self.committee, self._direct, self._account,
                    prior_endorsers=self._prior_endorsers,
                    defer_unresolved=True,
                )
                results = await self._resolve_deferred(batch, results)
                self._note_endorsements(blocks, results)
            else:
                self._account(0, len(blocks))
                token = _FLUSH_ARRIVED.set(arrived)
                try:
                    results = await self._direct(blocks)
                finally:
                    _FLUSH_ARRIVED.reset(token)
        except asyncio.CancelledError:
            # Cancelled mid-dispatch (node teardown): the window's futures
            # must still resolve, or verify() callers park forever.
            for _, future in batch:
                self._deferred.discard(id(future))
                if not future.done():
                    future.cancel()
            raise
        except Exception as exc:  # noqa: BLE001 - fail the window, keep serving
            # A kernel/runtime failure must not strand the awaiting tasks.
            # The ORIGINAL exception propagates (not a VerificationError): an
            # infra failure is not evidence the signatures were invalid.
            log.error("signature verifier crashed on %d blocks: %r", len(batch), exc)
            for _, future in batch:
                self._deferred.discard(id(future))
                if not future.done():
                    future.set_exception(exc)
            return
        if self.metrics is not None:
            self.metrics.verify_batch_size.observe(len(batch))
        for (_, future), ok in zip(batch, results):
            if ok is None:
                continue  # deferred: resolves with the next flush
            if not future.done():
                future.set_result(bool(ok))

    def _account(self, aggregated: int, direct: int) -> None:
        """Count skipped (aggregate-accepted) and directly dispatched
        blocks; the skips are also scrapeable as
        ``verified_signatures_total{backend="aggregate", outcome="skipped"}``
        (the direct ones count under their backend's label at dispatch)."""
        self.aggregated_total += aggregated
        self.direct_total += direct
        if self.metrics is not None and aggregated:
            self.metrics.verified_signatures_total.labels(
                "aggregate", "skipped"
            ).inc(aggregated)

    async def _resolve_deferred(self, batch, results):
        """Route ``None`` (unresolved) slots from an aggregate flush.

        First deferral: fold the entry into the NEXT flush window — it will
        be endorsed there by newly arrived children or dispatched as
        ordinary frontier, so this flush stays at one accelerator
        round-trip.  Second deferral: force a direct dispatch — a block that
        stays "maybe" across windows is either ahead of its children (direct
        check settles it) or a Byzantine park attempt (minting fresh
        endorsers each window must not stall it forever).
        """
        results = list(results)
        requeue, force = [], []
        for slot, ((block, future), ok) in enumerate(zip(batch, results)):
            if ok is not None:
                self._deferred.discard(id(future))
                continue
            if id(future) in self._deferred:
                self._deferred.discard(id(future))
                force.append((slot, block))
            else:
                self._deferred.add(id(future))
                requeue.append((block, future))
        if force:
            out = await self._direct([b for _, b in force])
            self.direct_total += len(force)
            for (slot, _), ok in zip(force, out):
                results[slot] = bool(ok)
        if requeue:
            loop = asyncio.get_running_loop()
            with self._lock:
                # Oldest first: deferred entries re-enter at the head.
                self._pending[:0] = requeue
                self._pending_arrived += loop.time() * len(requeue)
                if self._flush_task is None:
                    self._schedule_flush(loop)
        return results

    async def verify_blocks(self, blocks: Sequence[StatementBlock]) -> List[bool]:
        """All blocks of a frame join the collector CONCURRENTLY.  Only
        VerificationError means "invalid signature" (False); anything else
        (a kernel failure, CancelledError during shutdown) re-raises."""
        results = await asyncio.gather(
            *(self.verify(b) for b in blocks), return_exceptions=True
        )
        out: List[bool] = []
        for r in results:
            if isinstance(r, VerificationError):
                out.append(False)
            elif isinstance(r, BaseException):
                raise r
            else:
                out.append(True)
        return out

    ENDORSEMENT_MAX_ENTRIES = 200_000  # hard cap; FIFO eviction beyond it

    _EMPTY = frozenset()

    def _prior_endorsers(self, ref):
        # Callers must not mutate (endorsement_stake copies before mutating).
        return self._endorsements.get(ref, self._EMPTY)

    def _note_endorsements(self, blocks, results) -> None:
        """Record accepted blocks' includes in the endorsement index; only
        ACCEPTED blocks endorse (each was signature-verified or quorum-
        endorsed itself, so the license carries inductively).  Eviction is
        strictly by first-endorsement insertion order — recent entries (the
        live catch-up window) survive regardless of the rounds blocks CLAIM."""
        endorsements = self._endorsements
        for block, ok in zip(blocks, results):
            if not ok:
                continue
            author = block.author()
            for ref in block.includes:
                prev = endorsements.get(ref)
                if prev is None:
                    endorsements[ref] = {author}
                else:
                    prev.add(author)
        excess = len(endorsements) - self.ENDORSEMENT_MAX_ENTRIES
        if excess > 0:
            # dicts iterate in insertion order: drop the oldest entries.
            for ref in list(islice(iter(endorsements), excess)):
                del endorsements[ref]

    async def flush_now(self) -> None:
        """Test/shutdown hook: drain whatever is pending immediately —
        including aggregate-mode deferrals (a deferred entry re-enters
        ``_pending``; its second appearance force-dispatches, so this loop
        terminates)."""
        await self._flush()
        while self._pending:
            await self._flush()

    def health_state(self) -> dict:
        """Verifier-path state for the fleet health plane and the ingress
        plane's admission (``verify_occupancy``): breaker, routing pin, and
        staged-pipeline occupancy in one cheap read (unlocked snapshots —
        the readers tolerate a torn read)."""
        backend = self.verifier
        return {
            "breaker_open": bool(getattr(backend, "breaker_open", False)),
            "pinned_backend": getattr(backend, "pinned_backend", None),
            "backend": getattr(
                backend, "backend_label", type(backend).__name__
            ),
            "pipeline_inflight": self.pipeline.inflight,
            "pipeline_depth": self.pipeline.depth(),
        }
