"""Per-block span tracing: where did a block's latency go?

The port's copy of ``mysticeti_tpu.spans``.  Every block is tracked through
the pipeline as a sequence of structured spans keyed by
``(stage, block reference, authority)``.  The port's batching collector
(block_validator.py) records, per dispatched block, the staged pipeline's
sub-stages:

    verify_pack      host packing of the dispatch
    verify_device    non-blocking submission (kernels queued on the stream)
    verify_fetch     the result fetch (waits for the kernels)
    verify_dispatch  the whole dispatch

as one record a dispatch (:meth:`SpanTracer.begin_flush`), expanded into
those per-block events when read.  Off the simulator the collector also
records spans that belong to a dispatch ("flush") or to an offloaded frame
rather than to a block (:meth:`SpanTracer.record_interval`, the names in
``PORT_STAGES``), each carrying the flush's or frame's id.

The node's modules record the per-block pipeline proper (``receive`` and
``verify`` in net_sync.py, ``dag_add`` in net_sync.py and core.py,
``proposal_wait`` in core.py and commit_observer.py, ``commit`` in
syncer.py, ``finalize`` in commit_observer.py), which
``health.CriticalPathAnalyzer`` reads through :meth:`SpanTracer.add_sink`.

Spans are clocked by :func:`mysticeti_tpu_torch.runtime.now`.  Track
identity reuses :data:`tracing.current_authority` as the default, with
explicit ``authority=`` at sites that know their validator index.

Export is Chrome trace-event JSON, loadable in Perfetto / chrome://tracing:
set ``MYSTICETI_TRACE=/path/out.json`` (``%p`` expands to the pid) and
:func:`start_from_env` starts a tracer whose daemon thread flushes the file
atomically every few seconds, so a SIGKILL'd process still leaves a complete
snapshot; :func:`stop_from_env` writes the final trace.  :func:`install`
makes a tracer the live one without a file (tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import json
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

from .runtime import now as runtime_now
from .tracing import current_authority

# The central stage-name registry (the JAX package's, unchanged).
STAGES = (
    "propose",
    "transit",
    "receive",
    "verify",
    "verify_dispatch",
    # Staged dispatch pipeline sub-stages (verify_pipeline.py).
    "verify_pack",
    "verify_device",
    "verify_fetch",
    "dag_add",
    "proposal_wait",
    "commit",
    "finalize",
)

# The stages the port's batching collector records for every dispatched block.
VERIFY_STAGES = ("verify_pack", "verify_device", "verify_fetch", "verify_dispatch")

# The port's own span names (the JAX package has none of them): spans of one
# collector dispatch ("flush", args ``flush`` and ``lanes``) or of one
# offloaded frame (args ``frame`` and ``blocks``), recorded off the simulator
# through :meth:`SpanTracer.record_interval`.  The span-names lint accepts
# them beside ``STAGES``.
PORT_STAGES = (
    "flush_queue",  # the loop hands the submit to the executor -> it starts
    "flush_wire",  # KeyTable.indices_for + pack_blob_indexed
    "flush_upload",  # to_device_words
    "flush_launch",  # the prologue and keyed (or generic) launches
    "flush_fetch_queue",  # the loop hands the fetch to the executor -> it starts
    "flush_fetch",  # result(): the kernels' end and the copy back
    "offload_queue",  # DataPlaneOffload.run -> the worker starts the frame
    "offload_decode",  # the frame's decode on the offload worker
)
# The flush spans a dispatch through the CUDA backend records.
FLUSH_STAGES = PORT_STAGES[:6]

# The per-block pipeline proper: the stages every committed block crosses.
PIPELINE_STAGES = (
    "receive",
    "verify",
    "dag_add",
    "proposal_wait",
    "commit",
    "finalize",
)

ENV_TRACE = "MYSTICETI_TRACE"

# tid for spans recorded with no authority context (e.g. tooling).
_UNTRACKED_TID = 1 << 20


def format_ref(ref) -> str:
    """Stable human-readable block-reference label for trace args."""
    return f"A{ref.authority}R{ref.round}#{ref.digest[:4].hex()}"


class BlockFlush:
    """The per-block ``verify_*`` spans of one collector dispatch, held as
    one record (:meth:`SpanTracer.begin_flush`): ``verify_pack`` from the
    pack's start to the record's creation, then ``verify_device`` (off the
    simulator), ``verify_fetch`` and ``verify_dispatch`` as the dispatch
    reports them.  Each stage notifies the tracer's sinks once a block, as
    ``record_span`` would; reads expand the record into the same per-block
    events, labels formatted once."""

    __slots__ = ("_tracer", "refs", "authority", "kept", "pack", "device",
                 "final", "_labels")

    def __init__(self, tracer: "SpanTracer", refs: Sequence, authority: Optional[int],
                 t_pack: float, kept: bool) -> None:
        self._tracer = tracer
        self.refs = refs
        self.authority = authority
        self.kept = kept
        self.pack = (t_pack, runtime_now())
        # Set once each, as whole tuples, so a concurrent read sees a stage
        # either complete or absent.
        self.device: Optional[Tuple[float, float]] = None
        self.final: Optional[Tuple[float, float, float, Optional[dict]]] = None
        self._labels: Optional[List[str]] = None

    def device_done(self, t0: float, t1: float) -> None:
        """``verify_device``: from the pipeline slot to the submit's return."""
        self.device = (t0, t1)
        self._tracer._notify_all("verify_device", self.refs, self.authority, t0, t1)
        if not self.kept:
            self._tracer._count_dropped(len(self.refs))

    def done(self, t_fetch: float, t_dispatch: float, t1: float,
             dispatch_extra: Optional[dict] = None) -> None:
        """``verify_fetch`` from ``t_fetch`` and ``verify_dispatch`` from
        ``t_dispatch``, both to ``t1``; ``dispatch_extra`` lands in each
        ``verify_dispatch`` event's args."""
        self.final = (t_fetch, t_dispatch, t1, dispatch_extra)
        tracer = self._tracer
        if tracer._sinks:
            for ref in self.refs:
                tracer._notify("verify_fetch", ref, self.authority, t_fetch, t1)
                tracer._notify("verify_dispatch", ref, self.authority, t_dispatch, t1)
        if not self.kept:
            tracer._count_dropped(2 * len(self.refs))

    def expand(self) -> List[Tuple[str, str, Optional[int], float, float, Optional[dict]]]:
        """The per-block events of the stages completed so far."""
        if self._labels is None:
            self._labels = [format_ref(ref) for ref in self.refs]
        labels, a = self._labels, self.authority
        device, final = self.device, self.final
        out = [("verify_pack", label, a, *self.pack, None) for label in labels]
        if device is not None:
            out.extend(("verify_device", label, a, *device, None) for label in labels)
        if final is not None:
            t_fetch, t_dispatch, t1, extra = final
            for label in labels:
                out.append(("verify_fetch", label, a, t_fetch, t1, None))
                out.append(("verify_dispatch", label, a, t_dispatch, t1, extra))
        return out


class SpanTracer:
    """Collects per-block stage spans; exports Chrome trace-event JSON.

    Thread-safe: the periodic flusher reads from a daemon thread while the
    event loop and the collector's executor threads record.
    """

    # Hard caps: a long-lived node must not grow without bound; beyond the
    # cap new records are dropped (counted, never raising).
    MAX_EVENTS = 1_000_000
    MAX_OPEN = 200_000

    def __init__(
        self,
        flush_path: Optional[str] = None,
        flush_every_s: float = 5.0,
    ) -> None:
        # Completed spans: (stage, ref label, authority, t0, t1, extra args);
        # the label is None for a flush's or a frame's span, and a
        # BlockFlush stands for its dispatch's per-block spans.
        self._events: List = []
        # Events held, a BlockFlush counted as its four spans a block.
        self._n_events = 0
        # Clock anchor for cross-node trace merging: one (runtime, wall)
        # pair captured at the FIRST recorded span.
        self._anchor: Optional[Tuple[float, float]] = None
        # Open spans: (stage, ref, authority) -> t0.
        self._open: Dict[Tuple[str, object, Optional[int]], float] = {}
        # Live subscribers called with (stage, ref, authority, t0, t1) for
        # every COMPLETED span, outside the lock, on the recording thread;
        # sinks must be cheap and never raise.
        self._sinks: List = []
        self._lock = threading.Lock()
        # Serializes write(): the periodic flusher thread and an orderly-
        # shutdown flush_active() both target the same <path>.tmp.
        self._write_lock = threading.Lock()
        self.dropped = 0
        self.flush_path = flush_path
        self.flush_every_s = flush_every_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- clock --

    @staticmethod
    def now() -> float:
        """The runtime clock."""
        return runtime_now()

    @property
    def events(self) -> List[Tuple[str, Optional[str], Optional[int], float, float, Optional[dict]]]:
        """A snapshot of the completed spans, in recording order (a
        dispatch's per-block spans where its record was begun)."""
        with self._lock:
            return self._expanded()

    def _expanded(self) -> list:  # lint: holds[_lock]
        out: list = []
        for event in self._events:
            if isinstance(event, BlockFlush):
                out.extend(event.expand())
            else:
                out.append(event)
        return out

    # -- live span stream --

    def add_sink(self, sink) -> None:
        """Subscribe to the completed-span stream: ``sink(stage, ref,
        authority, t0, t1)`` per recorded span, event-cap independent."""
        self._sinks.append(sink)

    def _notify(self, stage, ref, authority, t0, t1) -> None:
        for sink in self._sinks:
            sink(stage, ref, authority, t0, t1)

    def _notify_all(self, stage, refs, authority, t0, t1) -> None:
        if self._sinks:
            for ref in refs:
                self._notify(stage, ref, authority, t0, t1)

    def _count_dropped(self, n: int) -> None:
        with self._lock:
            self.dropped += n

    def _admit(self, n: int) -> bool:  # lint: holds[_lock]
        """Room for ``n`` more events under the cap (counted as held)."""
        if self._n_events + n > self.MAX_EVENTS:
            return False
        self._n_events += n
        return True

    def _anchor_once(self) -> None:  # lint: holds[_lock]
        if self._anchor is None:
            from .runtime import timestamp_utc

            self._anchor = (runtime_now(), timestamp_utc())

    # -- recording --

    def record_span(
        self,
        stage: str,
        ref,
        t0: float,
        t1: Optional[float] = None,
        authority: Optional[int] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """Append a completed span measured by the caller.  ``extra`` lands
        in the exported event's ``args`` (next to the block label)."""
        if authority is None:
            authority = current_authority.get()
        if t1 is None:
            t1 = runtime_now()
        self._notify(stage, ref, authority, t0, t1)
        with self._lock:
            self._anchor_once()
            if not self._admit(1):
                self.dropped += 1
                return
            self._events.append(
                (stage, format_ref(ref), authority, t0, t1, extra)
            )

    def begin_flush(self, refs: Sequence, t_pack: float,
                    authority: Optional[int] = None) -> BlockFlush:
        """The per-block ``verify_*`` spans of one collector dispatch as ONE
        record (one locked append a dispatch instead of four a block):
        ``verify_pack`` from ``t_pack`` to now for each of ``refs``; the
        returned record takes the later stages.  A record the event cap
        refuses still notifies the sinks, and counts its spans as dropped."""
        if authority is None:
            authority = current_authority.get()
        with self._lock:
            self._anchor_once()
            kept = self._admit(4 * len(refs))
            flush = BlockFlush(self, refs, authority, t_pack, kept)
            if kept:
                self._events.append(flush)
            else:
                self.dropped += len(refs)
        self._notify_all("verify_pack", refs, authority, *flush.pack)
        return flush

    def record_interval(self, stage: str, t0: float, t1: float, args: dict,
                        authority: Optional[int] = None) -> None:
        """A completed span of a flush or a frame rather than of a block
        (a name from ``PORT_STAGES``): exported in the same Chrome trace,
        with ``args`` as its args and no block label; no sink sees it."""
        if authority is None:
            authority = current_authority.get()
        with self._lock:
            self._anchor_once()
            if not self._admit(1):
                self.dropped += 1
                return
            self._events.append((stage, None, authority, t0, t1, args))

    def begin_span(
        self,
        stage: str,
        ref,
        authority: Optional[int] = None,
        t: Optional[float] = None,
    ) -> None:
        """Open a span; a later :meth:`end_span` with the same key closes it.
        A key already open keeps its ORIGINAL start (duplicate deliveries
        must not shrink the measured wait)."""
        if authority is None:
            authority = current_authority.get()
        if t is None:
            t = runtime_now()
        key = (stage, ref, authority)
        with self._lock:
            if key not in self._open:
                if len(self._open) >= self.MAX_OPEN:
                    self.dropped += 1
                    return
                self._open[key] = t

    def end_span(
        self,
        stage: str,
        ref,
        authority: Optional[int] = None,
        t: Optional[float] = None,
    ) -> None:
        """Close an open span; silently ignored when no matching begin was
        seen."""
        if authority is None:
            authority = current_authority.get()
        key = (stage, ref, authority)
        if t is None:
            t = runtime_now()
        with self._lock:
            t0 = self._open.pop(key, None)
            if t0 is None:
                return
            self._anchor_once()
            if not self._admit(1):
                self.dropped += 1
            else:
                self._events.append(
                    (stage, format_ref(ref), authority, t0, t, None)
                )
        self._notify(stage, ref, authority, t0, t)

    @contextmanager
    def span(self, stage: str, ref, authority: Optional[int] = None):
        t0 = runtime_now()
        try:
            yield
        finally:
            self.record_span(stage, ref, t0, authority=authority)

    # -- export --

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        One track ("thread") per authority, named ``A<n>``; spans are
        complete ("X") events with microsecond timestamps, globally sorted
        on a total key so the output is deterministic.  Only COMPLETED spans
        are exported.  The process keeps the JAX package's name
        (``mysticeti-tpu``), so both packages' traces merge as one fleet.
        """
        pid = os.getpid()
        with self._lock:
            events = self._expanded()
            anchor = self._anchor

        def tid_of(authority: Optional[int]) -> int:
            return _UNTRACKED_TID if authority is None else authority

        tids = {}
        for _, _, authority, _, _, _ in events:
            tid = tid_of(authority)
            tids[tid] = "untracked" if authority is None else f"A{authority}"
        trace_events = [
            {
                "args": {"name": "mysticeti-tpu"},
                "name": "process_name",
                "ph": "M",
                "pid": pid,
            }
        ]
        for tid in sorted(tids):
            trace_events.append(
                {
                    "args": {"name": tids[tid]},
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                }
            )
        spans = [
            {
                "args": (
                    dict(extra)
                    if label is None
                    else {"block": label}
                    if not extra
                    else {"block": label, **extra}
                ),
                "cat": "pipeline",
                "dur": max(0, round((t1 - t0) * 1e6)),
                "name": stage,
                "ph": "X",
                "pid": pid,
                "tid": tid_of(authority),
                "ts": round(t0 * 1e6),
            }
            for stage, label, authority, t0, t1, extra in events
        ]
        spans.sort(key=lambda e: (e["ts"], e["tid"], e["name"], e["args"].get("block", ""), e["dur"]))
        trace_events.extend(spans)
        trace = {"displayTimeUnit": "ms", "traceEvents": trace_events}
        if anchor is not None:
            trace["otherData"] = {
                "clock_runtime_us": round(anchor[0] * 1e6),
                "clock_wall_us": round(anchor[1] * 1e6),
            }
        return trace

    def write(self, path: str) -> None:
        """Atomic write (tmp + rename): a SIGKILL landing mid-flush must not
        replace the previous complete snapshot with a truncated file."""
        tmp = f"{path}.tmp"
        with self._write_lock:
            with open(tmp, "w") as f:
                json.dump(
                    self.chrome_trace(), f, sort_keys=True,
                    separators=(",", ":"),
                )
                f.write("\n")
            os.replace(tmp, path)

    # -- periodic flush --

    def start(self) -> "SpanTracer":
        if self.flush_path and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run_flusher, name="mysticeti-tracer", daemon=True
            )
            self._thread.start()
        return self

    def _run_flusher(self) -> None:
        while not self._stop.wait(self.flush_every_s):
            try:
                self.write(self.flush_path)
            except OSError:
                pass

    def stop(self) -> None:
        """Stop the flusher and write the final complete trace."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if self.flush_path:
            self.write(self.flush_path)


# ---------------------------------------------------------------------------
# Process-global tracer (instrumentation sites read it on their hot path)

_active: Optional[SpanTracer] = None


def active() -> Optional[SpanTracer]:
    """The live tracer, or None when tracing is off."""
    return _active


def install(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Make ``tracer`` the live one (None turns tracing off); returns the
    previous tracer."""
    global _active
    previous, _active = _active, tracer
    return previous


def start_from_env() -> Optional[SpanTracer]:
    """Start trace collection when ``MYSTICETI_TRACE`` is set (call
    :func:`stop_from_env` at shutdown).  ``%p`` in the path expands to the
    pid so one env var serves a whole local fleet."""
    global _active
    path = os.environ.get(ENV_TRACE)
    if not path or _active is not None:
        return None
    path = path.replace("%p", str(os.getpid()))
    _active = SpanTracer(flush_path=path).start()
    return _active


def flush_active() -> None:
    """Write the live tracer's current snapshot NOW (orderly-shutdown hook).
    The tracer stays active — stop_from_env still finalizes it."""
    tracer = _active
    if tracer is None or not tracer.flush_path:
        return
    try:
        tracer.write(tracer.flush_path)
    except OSError:
        pass


def stop_from_env() -> None:
    """Write the final trace and deactivate the global tracer."""
    global _active
    if _active is None:
        return
    _active.stop()
    _active = None


# ---------------------------------------------------------------------------
# Shared trace loading + stage extraction (one implementation for every
# offline consumer, so a trace torn mid-flush is read the same way by all).


def salvage_trace_events(text: str) -> List[dict]:
    """Recover complete event objects from a truncated trace: find the
    traceEvents array and raw-decode objects one at a time until the tear."""
    start = text.find('"traceEvents"')
    if start < 0:
        return []
    start = text.find("[", start)
    if start < 0:
        return []
    decoder = json.JSONDecoder()
    events: List[dict] = []
    pos = start + 1
    n = len(text)
    while pos < n:
        while pos < n and text[pos] in " \t\r\n,":
            pos += 1
        if pos >= n or text[pos] == "]":
            break
        try:
            event, pos = decoder.raw_decode(text, pos)
        except ValueError:
            break  # the tear: everything before it is intact
        if isinstance(event, dict):
            events.append(event)
    return events


def _salvage_other_data(text: str) -> dict:
    """The clock anchor survives most tears (sort_keys puts ``otherData``
    before ``traceEvents``); best-effort recover it."""
    start = text.find('"otherData"')
    if start < 0:
        return {}
    start = text.find("{", start + len('"otherData"'))
    if start < 0:
        return {}
    try:
        other, _ = json.JSONDecoder().raw_decode(text, start)
    except ValueError:
        return {}
    return other if isinstance(other, dict) else {}


def load_trace_events(path: str):
    """All events from a Chrome trace-event JSON file.

    Returns ``(events, note, other_data)``: a truncated tail is tolerated by
    salvaging the complete events before the tear (reported through
    ``note``); ``other_data`` carries the clock anchor when present.
    """
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        events = salvage_trace_events(text)
        note = (
            f"note: trace is truncated (mid-flush tail?); salvaged "
            f"{len(events)} complete event(s)"
        )
        return events, note, _salvage_other_data(text)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            return [], "note: no traceEvents array in trace", {}
        return events, "", data.get("otherData") or {}
    if isinstance(data, list):
        return data, "", {}
    return [], "note: unrecognized trace shape", {}


def complete_spans(events: List[dict]) -> List[dict]:
    """Complete ("X") span events."""
    return [e for e in events if e.get("ph") == "X"]


def track_names(events: List[dict]) -> Dict[Tuple[int, int], str]:
    """(pid, tid) -> track name from the thread_name metadata events."""
    return {
        (e.get("pid", 0), e.get("tid", 0)): e["args"]["name"]
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }


def stage_chains(
    span_events: List[dict], stages: Optional[Tuple[str, ...]] = None
) -> Dict[Tuple[Tuple[int, int], str], Dict[str, Tuple[int, int]]]:
    """Per-block stage chains: ``(track=(pid, tid), block label) ->
    {stage: (first ts µs, max dur µs)}``.

    Duplicate spans for the same (track, block, stage) keep the EARLIEST
    start and the LONGEST duration.  ``stages`` filters which span names
    participate (default: every registered stage).
    """
    allowed = set(stages if stages is not None else STAGES)
    chains: Dict[Tuple[Tuple[int, int], str], Dict[str, Tuple[int, int]]] = {}
    for e in span_events:
        name = e.get("name")
        if name not in allowed:
            continue
        label = (e.get("args") or {}).get("block")
        if not label:
            continue
        track = (e.get("pid", 0), e.get("tid", 0))
        ts = e.get("ts", 0)
        dur = e.get("dur", 0)
        entry = chains.setdefault((track, label), {})
        prev = entry.get(name)
        if prev is None:
            entry[name] = (ts, dur)
        else:
            entry[name] = (min(prev[0], ts), max(prev[1], dur))
    return chains
