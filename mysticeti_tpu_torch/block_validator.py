"""Pluggable block verification seam, with the batched GPU signature verifier.

The port's copy of ``mysticeti_tpu.block_validator``, trimmed to the node's
accelerator path: ``BlockVerifier`` / ``AcceptAllBlockVerifier``, the
``SignatureVerifier`` backends (the CPU oracle and ``TorchSignatureVerifier``,
the counterpart of ``TpuSignatureVerifier``), and the batching collector
``BatchedSignatureVerifier`` without threshold aggregation.  The hybrid
router and its circuit breaker, the aggregate verifier and the verifier
service client are not carried over.

Split of responsibilities on the receive path:
  * consensus-rule checks (digest, epoch, author, includes, threshold clock) —
    host, cheap, per-block: ``StatementBlock.verify_structure``
  * Ed25519 signature — batched: ``BatchedSignatureVerifier`` over
    ``TorchSignatureVerifier`` (CUDA kernels) or ``CpuSignatureVerifier``
"""
from __future__ import annotations

import asyncio
import threading
import time
from typing import List, Optional, Sequence, Tuple

from . import spans
from .committee import Committee
from .tracing import logger
from .types import StatementBlock, VerificationError
from .utils.tasks import spawn_logged
from .verify_pipeline import (
    STAGE_DEVICE,
    STAGE_FETCH,
    STAGE_PACK,
    DeferredDispatch,
    VerifyPipeline,
)

log = logger(__name__)

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
    """The CUDA kernels (ops/ed25519_cuda.py) behind the fused raw-bytes path,
    on one device.

    With ``committee_keys`` the signer set is known: the keys and their
    combs live on the device in a ``KeyTable``, a signature rides as an
    index (26 words on the wire instead of 33), and chunks whose per-key
    grouping fits take the keyed kernel.  ``device`` defaults to ``cuda``
    and raises without a card; ``device="cpu"`` runs the kernels' plain
    PyTorch versions."""

    def __init__(self, committee_keys=None, device=None) -> None:
        from .ops.ed25519 import KeyTable, resolve_device

        self.device = resolve_device(device)
        self._table = None
        if committee_keys:
            self._table = KeyTable(list(committee_keys), device=self.device)

    def warmup(self) -> None:
        """Pay one-time costs (the kernels' build, the comb upload, the key
        combs) before the first real batch: a one-unknown-key batch and, with
        a committee table, a one-signature-per-key batch."""
        dummy = bytes(32)
        self.verify_signatures([dummy], [dummy], [bytes(64)])
        if self._table is not None:
            self._table.neg_combs()
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
        on the device's stream; ``result()`` pays the single copy back."""
        from .ops import ed25519

        if self._table is not None:
            return ed25519.dispatch_batch_table(self._table, public_keys, digests, signatures)
        return ed25519.dispatch_batch(public_keys, digests, signatures, self.device)

    def verify_signatures(self, public_keys, digests, signatures):
        return list(self.verify_signatures_async(public_keys, digests, signatures).result())


def _update_ema(current: float, sample: float, outlier_s: float) -> float:
    """EMA with outlier rejection: samples past ``outlier_s`` (one-time
    kernel builds) never enter; the first sample seeds."""
    if sample >= outlier_s:
        return current
    return sample if current == 0.0 else 0.8 * current + 0.2 * sample


def _observe_orphan(fut) -> None:
    """Retrieve an orphaned executor future's exception so a backend crash
    after the awaiting flush was cancelled is logged, not swallowed into an
    'exception was never retrieved' warning at shutdown."""
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        log.warning("orphaned verify dispatch failed after cancel: %r", exc)


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
    """

    MAX_ADAPTIVE_DELAY_S = 0.1
    MIN_ADAPTIVE_DELAY_S = 0.0005
    EMA_OUTLIER_S = 5.0
    # Inter-arrival gaps are clamped here before entering the EMA: an idle
    # stretch means "low rate", but it must not drag the EMA so far that a
    # resuming burst needs minutes of samples to recover the window.
    ARRIVAL_GAP_CAP_S = 1.0

    def __init__(
        self,
        committee: Committee,
        verifier: SignatureVerifier,
        max_batch: int = 256,
        max_delay_s: float = 0.005,
        pipeline_depth: Optional[int] = None,
    ) -> None:
        self.committee = committee
        self.verifier = verifier
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        # Staged dispatch window: several flushes may be in flight at once
        # (pack N+1 while N computes and N-1's results ride back), bounded
        # so a flooding peer cannot queue unbounded device work.
        self.pipeline = VerifyPipeline(
            depth=pipeline_depth, fixed_cost_fn=self._pipeline_fixed_cost
        )
        self.direct_total = 0
        self._pending: List[Tuple[StatementBlock, asyncio.Future]] = []
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
        collector's own dispatch-latency EMA (an unlocked snapshot)."""
        return self._dispatch_ema_s

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
        """Arm the window timer (caller holds ``self._lock``)."""
        self._flush_task = loop.call_later(
            self._effective_delay_s(), lambda: spawn_logged(self._flush(), log, name="verify-flush")
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
            if len(self._pending) >= self.max_batch:
                # Take the full window NOW and open a fresh one.
                window = self._pending
                self._pending = []
                if self._flush_task is not None:
                    self._flush_task.cancel()
                    self._flush_task = None
            elif self._flush_task is None:
                self._schedule_flush(loop)
        if window is not None:
            # Flush as its own task: the prior window's dispatch may still be
            # in flight, and the bounded pipeline lets this pack overlap it.
            spawn_logged(self._flush(window), log, name="verify-flush")
        ok = await future
        if not ok:
            raise VerificationError(
                f"signature verification failed for {block.reference!r}"
            )

    def _submit_dispatch(self, pks, digests, sigs):
        """Device stage (executor thread): pack-to-wire + non-blocking
        submission through the backend's async seam."""
        return self.verifier.verify_signatures_async(pks, digests, sigs)

    @staticmethod
    def _fetch_dispatch(handle):
        """Fetch stage (executor thread): block until the verdicts are ready."""
        return handle.result()

    async def _direct(self, blocks) -> List[bool]:
        """One dispatch of ``blocks``' signatures through the pipeline."""
        loop = asyncio.get_running_loop()
        tracer = spans.active()
        # -- pack stage (host, loop thread): key lookup + list building; the
        # numpy pack-to-wire happens inside the submit below.
        t_pack = tracer.now() if tracer is not None else 0.0
        pack_started = time.monotonic()
        pks = [self.committee.get_public_key(b.author()).bytes for b in blocks]
        digests = [b.signed_digest() for b in blocks]
        sigs = [b.signature for b in blocks]
        self.pipeline.note_stage(STAGE_PACK, time.monotonic() - pack_started)
        if tracer is not None:
            for block in blocks:
                tracer.record_span("verify_pack", block.reference, t_pack)
        # -- bounded in-flight window, held from submission through fetch.
        async with self.pipeline.slot():
            t_dispatch = tracer.now() if tracer is not None else 0.0
            started = time.monotonic()
            submit_fut = loop.run_in_executor(
                None, self._submit_dispatch, pks, digests, sigs
            )
            try:
                handle = await asyncio.shield(submit_fut)
            except asyncio.CancelledError:
                # Cancelled mid-submit (node shutdown): the shielded job still
                # runs; observe its outcome when it lands.
                submit_fut.add_done_callback(_observe_orphan)
                raise
            device_done = time.monotonic()
            self.pipeline.note_stage(STAGE_DEVICE, device_done - started)
            t_fetch = t_dispatch
            if tracer is not None:
                t_fetch = tracer.now()
                for block in blocks:
                    tracer.record_span(
                        "verify_device", block.reference, t_dispatch, t1=t_fetch
                    )
            # Shielded for the same reason: an unshielded cancel can cancel a
            # QUEUED executor job, and then nothing consumes the handle.
            fetch_fut = loop.run_in_executor(None, self._fetch_dispatch, handle)
            try:
                out = await asyncio.shield(fetch_fut)
            except asyncio.CancelledError:
                fetch_fut.add_done_callback(_observe_orphan)
                raise
            self.pipeline.note_stage(STAGE_FETCH, time.monotonic() - device_done)
        with self._lock:
            self._dispatch_ema_s = _update_ema(
                self._dispatch_ema_s, time.monotonic() - started, self.EMA_OUTLIER_S
            )
        if tracer is not None:
            t1 = tracer.now()
            for block in blocks:
                tracer.record_span("verify_fetch", block.reference, t_fetch, t1=t1)
                tracer.record_span("verify_dispatch", block.reference, t_dispatch, t1=t1)
        return out

    async def _flush(self, batch=None) -> None:
        if batch is None:
            with self._lock:
                batch = self._pending
                self._pending = []
                if self._flush_task is not None:
                    self._flush_task.cancel()
                    self._flush_task = None
        if not batch:
            return
        self.direct_total += len(batch)
        try:
            results = await self._direct([b for b, _ in batch])
        except asyncio.CancelledError:
            # Cancelled mid-dispatch (node teardown): the window's futures
            # must still resolve, or verify() callers park forever.
            for _, future in batch:
                if not future.done():
                    future.cancel()
            raise
        except Exception as exc:  # noqa: BLE001 - fail the window, keep serving
            # A kernel/runtime failure must not strand the awaiting tasks.
            # The ORIGINAL exception propagates (not a VerificationError): an
            # infra failure is not evidence the signatures were invalid.
            log.error("signature verifier crashed on %d blocks: %r", len(batch), exc)
            for _, future in batch:
                if not future.done():
                    future.set_exception(exc)
            return
        for (_, future), ok in zip(batch, results):
            if not future.done():
                future.set_result(bool(ok))

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

    async def flush_now(self) -> None:
        """Test/shutdown hook: drain whatever is pending immediately."""
        await self._flush()
