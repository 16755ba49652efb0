"""Sampling profiler + per-subsystem CPU accountant + flamegraph rendering.

The port's copy of ``mysticeti_tpu.profiling``.  An in-process sampling
profiler reads every thread's stack via ``sys._current_frames()`` at a fixed
rate and aggregates *folded stacks* (the stackcollapse format), and
:func:`flamegraph_svg` renders folded stacks straight to a self-contained
SVG — no perf, no external scripts.

Host attribution plane: the same per-tick stack walk also feeds a
:class:`SubsystemAccountant` — every sampled stack resolves to exactly one
entry of the declarative :data:`SUBSYSTEMS` registry (the totality of the
mapping over the port's package is pinned by a test), so the node exports
``mysticeti_cpu_seconds_total{subsystem, thread_class}`` and
per-committed-leader normalized costs instead of one whole-process flame
dump.  The census walk additionally estimates the GIL convoy (ticks where
≥2 threads were runnable at once) — with one interpreter lock, two runnable
threads means one of them is waiting for the GIL.

The sampler sees Python frames only: a thread waiting on the card inside a
torch call (a fetch's ``.cpu()``, an event sync) is runnable in its last
Python frame, so it is charged to ``verifier-pack`` and counts toward the
convoy estimate.

Wire-up: ``MYSTICETI_PROFILE=/path/out.folded`` makes a node sample for its
whole lifetime and write the folded file at shutdown (``start_from_env`` /
``stop_from_env``); ``python -m mysticeti_tpu_torch.tools.mkflamegraph
out.folded > flame.svg`` renders it and ``--diff base.folded new.folded``
renders an A/B flame diff.  ``MYSTICETI_PERF_REPORT=/path/report.json``
writes the deterministic attribution report at shutdown.
"""
from __future__ import annotations

import json
import os
import sys
import threading
from collections import Counter
from html import escape
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_HZ = 99.0  # the classic perf sampling rate (mkflamegraph.sh -F 99)

# ---------------------------------------------------------------------------
# The subsystem registry
# ---------------------------------------------------------------------------
#
# Declarative module-basename -> subsystem map.  Every module under
# ``mysticeti_tpu_torch/`` must resolve through this table (totality is
# enforced by tests/test_torch_hostattr.py), so a new module cannot silently
# land its CPU time in "other".  Frames from outside the package (torch,
# numpy, stdlib) never match here — attribution
# walks leaf→root and charges the first *in-package* frame, so a numpy core
# routine called from serde.py is charged to mesh-parse, not to "other".

SUBSYSTEMS: Dict[str, str] = {
    # Consensus core: DAG state machine + the single-owner core task.
    "core": "core", "core_task": "core", "syncer": "core",
    "block_manager": "core", "block_handler": "core",
    "threshold_clock": "core", "state": "core", "committee": "core",
    "config": "core", "types": "core", "range_map": "core",
    "dag": "core", "lock": "core", "tasks": "core", "epoch_close": "core",
    # Epoch reconfiguration: the fold runs inline on the core commit path.
    "reconfig": "core",
    # Execution state machine: folded inline on the core commit path.
    "execution": "core",
    # Commit linearization + interpretation.
    "linearizer": "linearizer", "base_committer": "linearizer",
    "universal_committer": "linearizer", "commit_observer": "linearizer",
    "finalization_interpreter": "linearizer",
    # Decision ledger: recorded inline from try_commit on the core path.
    "decisions": "linearizer",
    # Host-side digest/signature oracles.
    "crypto": "digest", "_ed25519_py": "digest",
    # Verifier hot path: batch collection, packing, kernels.
    "block_validator": "verifier-pack", "verify_pipeline": "verifier-pack",
    "verifier_service": "verifier-pack", "ed25519": "verifier-pack",
    "ed25519_pallas": "verifier-pack", "field": "verifier-pack",
    "scalar": "verifier-pack", "sha512": "verifier-pack",
    "mesh": "verifier-pack",
    # The CUDA kernels' wrappers and their nvcc build.
    "ed25519_cuda": "verifier-pack", "cuda_build": "verifier-pack",
    # Durability plane.
    "wal": "wal", "storage": "wal", "block_store": "wal",
    # Client ingress (finality tracks submit→finality over ingress keys).
    "ingress": "ingress", "transactions_generator": "ingress",
    "finality": "ingress",
    # Mesh data plane: frame encode/fan-out vs receive/decode.
    "net_sync": "mesh-parse", "synchronizer": "mesh-encode",
    "network": "mesh-encode", "simulated_network": "mesh-encode",
    "serde": "mesh-parse",
    # Observability plane itself (metrics sweeps, tracing, this module).
    "metrics": "obs", "health": "obs", "spans": "obs", "tracing": "obs",
    "profiling": "obs", "flight_recorder": "obs", "hostattr": "obs",
    "log": "obs",
    # Tooling / harness code that can appear inside a node process.
    "cli": "tooling", "__main__": "tooling", "adversary": "tooling",
    "chaos": "tooling", "scenarios": "tooling", "checker": "tooling",
    "detflow": "tooling", "races": "tooling", "lockgraph": "tooling",
    "detsan": "tooling",
    "benchmark": "tooling", "display": "tooling", "faults": "tooling",
    "hostmon": "tooling", "logs": "tooling", "measurement": "tooling",
    "monitor": "tooling", "orchestrator": "tooling", "plot": "tooling",
    "providers": "tooling", "runner": "tooling", "settings": "tooling",
    "ssh": "tooling", "testbed": "tooling", "validator": "tooling",
    # The entry points, the benchmark, the flamegraph renderer's CLI, the
    # node-a-process attribution probe, the scenario-matrix probe, the lint's
    # alias, the trace and fleet-health tools, the kernel and storage tools,
    # the load and catch-up fleet benches and the data-plane, mesh,
    # reconfiguration, finality and execution probes (``tools/detsan.py``
    # shares ``detsan``'s row).
    "entry": "tooling", "bench": "tooling", "mkflamegraph": "tooling",
    "perf_attr": "tooling", "scenario_matrix": "tooling", "lint": "tooling",
    "trace_report": "tooling", "fleet_trace": "tooling", "fleetmon": "tooling",
    "kernel_parity": "tooling", "bench_probe": "tooling", "mesh_scaling": "tooling",
    "bench_trend": "tooling", "wal_inspect": "tooling", "storage_probe": "tooling",
    "commit_explain": "tooling", "maxload_bench": "tooling", "chip_window_ab": "tooling",
    "node_bench": "tooling", "catchup_bench": "tooling", "overload_bench": "tooling",
    "dataplane_ab": "tooling", "mesh_ab": "tooling", "reconfig_matrix": "tooling",
    "finality_bench": "tooling", "execution_bench": "tooling", "dataplane_split": "tooling",
    # Runtime facade + the deterministic loop.
    "__init__": "runtime", "simulated": "runtime",
}

# Exact (module, function) overrides checked before the module map: GC work
# lives inside wal/storage/core modules but is its own budget line.
# Leaf-most match wins, whole stack is scanned — a
# wal append *inside* retire_below is GC cost, not steady-state WAL cost.
FRAME_SUBSYSTEMS: Dict[Tuple[str, str], str] = {
    ("syncer", "cleanup"): "gc",
    ("storage", "cleanup"): "gc",
    ("storage", "retire_below"): "gc",
    ("storage", "gc_target"): "gc",
    ("block_store", "cleanup"): "gc",
    ("block_store", "retire_below_round"): "gc",
    # Wire-block decode is mesh-parse cost wherever it bottoms out — the
    # leaf-most in-package frame would otherwise charge it to "core"
    # (types.py's module row).  Covers both the inline receive path and
    # the dataplane-offload worker; WAL-reload decode rides along (decode
    # is decode).
    ("types", "from_bytes"): "mesh-parse",
    ("types", "from_bytes_many"): "mesh-parse",
}

# Leaf frames that mean "this thread is parked, not burning CPU": the event
# loop in select, executor/WAL threads waiting on queues and locks.  A tick
# whose stack bottoms out here charges event-loop-idle and does not count as
# runnable for the convoy estimate.
WAITING_LEAVES = frozenset([
    ("selectors", "select"),
    ("selectors", "_select"),
    ("threading", "wait"),
    ("threading", "_wait_for_tstate_lock"),
    ("queue", "get"),
    ("socket", "accept"),
    ("thread", "_worker"),
])

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))

# The full set of subsystem names (tests + budget rows iterate it).
SUBSYSTEM_NAMES: Tuple[str, ...] = tuple(sorted(
    set(SUBSYSTEMS.values())
    | set(FRAME_SUBSYSTEMS.values())
    | {"event-loop-idle", "other"}
))


def attribute(frames: Sequence[Tuple[str, str, bool]]) -> str:
    """Resolve one sampled stack to a subsystem.

    ``frames`` is leaf-first ``(module, function, in_package)`` triples.
    Order of precedence: a parked leaf is idle; any frame matching an exact
    :data:`FRAME_SUBSYSTEMS` override (leaf-most first) wins next — GC work
    is GC wherever it bottoms out; otherwise the leaf-most *in-package*
    frame's module decides — third-party frames (torch, numpy, stdlib) are
    charged to whichever package module called into them.
    """
    if not frames:
        return "other"
    leaf_mod, leaf_fn, _ = frames[0]
    if (leaf_mod, leaf_fn) in WAITING_LEAVES:
        return "event-loop-idle"
    for module, func, _in_pkg in frames:
        sub = FRAME_SUBSYSTEMS.get((module, func))
        if sub is not None:
            return sub
    for module, _func, in_pkg in frames:
        if in_pkg:
            sub = SUBSYSTEMS.get(module)
            if sub is not None:
                return sub
    return "other"


def thread_class_of(name: str) -> str:
    """Coarse thread taxonomy for the cpu-seconds label: the event-loop
    owner, the data-plane offload worker, verifier executor / dispatch
    threads, the WAL writer, rest."""
    if name == "MainThread":
        return "loop"
    low = name.lower()
    # Before the generic "threadpool" catch: the offload pool's threads are
    # named dataplane-offload_N (core_task.DataPlaneOffload) and carry
    # decode/digest burn, not signature verification.
    if "offload" in low:
        return "offload"
    if "verif" in low or "jax" in low or "threadpool" in low:
        return "verifier"
    if "wal" in low or "fsync" in low:
        return "wal"
    return "aux"


class SubsystemAccountant:
    """Per-subsystem CPU-time accumulator fed by the sampler's census.

    ``ingest_census`` is the synthetic-census seam: tests (and the
    determinism pin) feed hand-built censuses and get byte-identical
    reports; in production the sampler thread feeds one census per tick.
    The shared counters are mutated from the sampler thread and read by
    ``publish``/``report`` from the metrics/health side, so every mutation
    holds ``_acct_lock`` (GUARDED_FIELDS, docs/static-analysis.md).
    """

    def __init__(self) -> None:
        self._acct_lock = threading.Lock()
        self._cpu_seconds: Dict[Tuple[str, str], float] = {}
        self._census_ticks = 0
        self._convoy_ticks = 0
        self._runnable_sum = 0
        self._published: Dict[Tuple[str, str], float] = {}
        self._metrics = None
        self._leaders_fn = None

    def bind(self, metrics, leaders_fn=None) -> None:
        """Late-bind the metrics registry (+ committed-leader source for the
        normalized gauges): the sampler starts from the env before the
        validator has built its Metrics."""
        self._metrics = metrics
        self._leaders_fn = leaders_fn

    # -- ingestion (sampler thread; or tests, synthetically) --

    def ingest_census(
        self,
        samples: Sequence[Tuple[str, Sequence[Tuple[str, str, bool]]]],
        dt: float,
    ) -> None:
        """One census tick: ``samples`` is ``(thread_class, frames)`` per
        live thread (frames leaf-first, as :func:`attribute` takes them);
        each thread is charged ``dt`` seconds against its subsystem."""
        attributed: List[Tuple[str, str]] = []
        runnable = 0
        for thread_class, frames in samples:
            sub = attribute(frames)
            attributed.append((sub, thread_class))
            if sub != "event-loop-idle":
                runnable += 1
        with self._acct_lock:
            self._census_ticks += 1
            self._runnable_sum += runnable
            if runnable >= 2:
                # With one GIL, two simultaneously-runnable threads mean one
                # of them is waiting on the interpreter lock this tick.
                self._convoy_ticks += 1
            for key in attributed:
                self._cpu_seconds[key] = self._cpu_seconds.get(key, 0.0) + dt

    # -- export --

    def publish(self) -> None:
        """Sync accumulated deltas into the prometheus series (counter incs
        + the per-leader and convoy gauges).  Called on the sampler's flush
        cadence and at stop; cheap, idempotent, no-op until bound."""
        metrics = self._metrics
        if metrics is None:
            return
        with self._acct_lock:
            totals = dict(self._cpu_seconds)
            census = self._census_ticks
            convoy = self._convoy_ticks
        for key in sorted(totals):
            delta = totals[key] - self._published.get(key, 0.0)
            if delta > 0:
                subsystem, thread_class = key
                metrics.mysticeti_cpu_seconds_total.labels(
                    subsystem, thread_class
                ).inc(delta)
                self._published[key] = totals[key]
        if census:
            metrics.mysticeti_gil_convoy_ratio.set(convoy / census)
        leaders = self._leaders_fn() if self._leaders_fn is not None else 0
        if leaders:
            per_sub: Dict[str, float] = {}
            for (subsystem, _tc), seconds in totals.items():
                if subsystem != "event-loop-idle":
                    per_sub[subsystem] = per_sub.get(subsystem, 0.0) + seconds
            for subsystem in sorted(per_sub):
                metrics.mysticeti_cpu_us_per_leader.labels(subsystem).set(
                    per_sub[subsystem] * 1e6 / leaders
                )

    def report(self) -> dict:
        """The deterministic attribution report: plain rounded numbers,
        sorted keys — a seeded synthetic census reproduces it byte-for-byte
        (pinned by tests/test_torch_hostattr.py)."""
        with self._acct_lock:
            totals = dict(self._cpu_seconds)
            census = self._census_ticks
            convoy = self._convoy_ticks
            runnable = self._runnable_sum
        per_sub: Dict[str, float] = {}
        for (subsystem, _tc), seconds in totals.items():
            per_sub[subsystem] = per_sub.get(subsystem, 0.0) + seconds
        busy = sum(s for k, s in per_sub.items() if k != "event-loop-idle")
        other = per_sub.get("other", 0.0)
        return {
            "census_ticks": census,
            "convoy_ticks": convoy,
            "gil_convoy_ratio": round(convoy / census, 6) if census else 0.0,
            "mean_runnable": round(runnable / census, 6) if census else 0.0,
            "cpu_seconds": {
                f"{sub}/{tc}": round(seconds, 6)
                for (sub, tc), seconds in sorted(totals.items())
            },
            "subsystem_seconds": {
                sub: round(seconds, 6) for sub, seconds in sorted(per_sub.items())
            },
            "attributed_ratio": (
                round((busy - other) / busy, 6) if busy else 1.0
            ),
        }

    def report_bytes(self) -> bytes:
        return (
            json.dumps(self.report(), sort_keys=True, separators=(",", ":"))
            + "\n"
        ).encode()


class SamplingProfiler:
    """Samples all Python threads' stacks into folded-stack counts.

    The sampler thread is a daemon and costs one ``_current_frames`` walk per
    tick (~10 µs per thread) — cheap enough to run for a whole benchmark.
    The same walk feeds the accountant's census when one is attached (one
    stack walk serves both the flamegraph and the attribution plane).
    """

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        flush_path: Optional[str] = None,
        flush_every_s: float = 10.0,
        accountant: Optional[SubsystemAccountant] = None,
    ) -> None:
        self.interval_s = 1.0 / hz
        self.counts: Counter = Counter()
        # Periodic flush: benchmark fleets kill nodes with SIGKILL (no
        # shutdown path runs), so a profile that only writes at stop() would
        # never land on disk — flush the folded file from the sampler thread.
        self.flush_path = flush_path
        self.flush_every_s = flush_every_s
        self.accountant = accountant
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        # Under the deterministic simulator the node lives in virtual time:
        # a wall-clocked sampler thread would charge arbitrary real time
        # against virtual work and make seeded runs nondeterministic.  Tests
        # exercise the attribution plane through the synthetic-census seam.
        from .runtime import is_simulated

        if is_simulated():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mysticeti-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if self.accountant is not None:
            self.accountant.publish()

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- sampling --

    def _run(self) -> None:
        me = threading.get_ident()
        import time as _time

        next_flush = _time.monotonic() + self.flush_every_s
        while not self._stop.wait(self.interval_s):
            names = {t.ident: t.name for t in threading.enumerate()}
            census: List[Tuple[str, List[Tuple[str, str, bool]]]] = []
            for ident, top in sys._current_frames().items():
                if ident == me:
                    continue
                frames: List[str] = []
                triples: List[Tuple[str, str, bool]] = []
                frame = top
                while frame is not None:
                    code = frame.f_code
                    module = os.path.splitext(
                        os.path.basename(code.co_filename)
                    )[0]
                    frames.append(f"{module}:{code.co_name}")
                    triples.append((
                        module,
                        code.co_name,
                        code.co_filename.startswith(_PKG_DIR),
                    ))
                    frame = frame.f_back
                if frames:
                    self.counts[";".join(reversed(frames))] += 1
                    census.append(
                        (thread_class_of(names.get(ident, "")), triples)
                    )
            if self.accountant is not None and census:
                self.accountant.ingest_census(census, self.interval_s)
            # Sampler-thread body: the profiler never starts under the sim
            # (health.py gates it), so this cadence is real-mode-only.
            if self.flush_path and _time.monotonic() >= next_flush:  # lint: ignore[sim-taint]
                next_flush = _time.monotonic() + self.flush_every_s
                try:
                    self.write_folded(self.flush_path)
                except OSError:
                    pass
                if self.accountant is not None:
                    self.accountant.publish()

    # -- output --

    def folded(self) -> List[str]:
        """Folded-stack lines, most frequent first: ``a;b;c 42``."""
        return [f"{stack} {n}" for stack, n in self.counts.most_common()]

    def write_folded(self, path: str) -> None:
        # Atomic swap: the periodic flush exists to survive SIGKILL, so a
        # kill landing mid-write must not destroy the previous complete
        # flush with a truncated file.
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            for line in self.folded():
                f.write(line + "\n")
        os.replace(tmp, path)


def load_folded(path: str) -> List[str]:
    """Read a folded file, salvaging the torn-profile cases the way
    ``trace_report`` salvages traces: a node SIGKILL'd before its first
    complete flush leaves only ``<path>.tmp`` (possibly with a torn last
    line — building the trie skips malformed lines), so fall back to it
    rather than dying on the missing main file."""
    for candidate in (path, f"{path}.tmp"):
        try:
            with open(candidate) as f:
                return f.read().splitlines()
        except OSError:
            continue
    raise FileNotFoundError(path)


# ---------------------------------------------------------------------------
# Flamegraph rendering (flamegraph.pl equivalent)
# ---------------------------------------------------------------------------

_FRAME_H = 16
_FONT_SIZE = 11
_PALETTE = ("#e4572e", "#e8864a", "#f0a868", "#f6c28b", "#c96e3b", "#d88c51")


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self.children: Dict[str, "_Node"] = {}


def _build_trie(folded_lines: Iterable[str]) -> _Node:
    root = _Node("all")
    for line in folded_lines:
        line = line.strip()
        if not line:
            continue
        stack, _, count_s = line.rpartition(" ")
        try:
            count = int(count_s)
        except ValueError:
            continue
        root.value += count
        node = root
        for frame in stack.split(";"):
            child = node.children.get(frame)
            if child is None:
                child = node.children[frame] = _Node(frame)
            child.value += count
            node = child
    return root


def _depth(node: _Node) -> int:
    return 1 + max((_depth(c) for c in node.children.values()), default=0)


def flamegraph_svg(
    folded_lines: Iterable[str],
    title: str = "mysticeti-tpu flamegraph",
    width: int = 1200,
) -> str:
    """Render folded stacks to a self-contained SVG string.

    Layout matches flamegraph.pl: x = fraction of total samples, one row per
    stack depth, alpha-ordered siblings; every rect carries a ``<title>``
    tooltip with the frame name, sample count, and percentage.
    """
    root = _build_trie(folded_lines)
    if root.value == 0:
        root.value = 1
    height = (_depth(root) + 1) * _FRAME_H + 40
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}"'
        f' height="{height}" font-family="monospace" font-size="{_FONT_SIZE}">',
        f'<text x="{width // 2}" y="20" text-anchor="middle"'
        f' font-size="14">{escape(title)}</text>',
    ]
    total = root.value

    def emit(node: _Node, x: float, level: int, color_idx: int) -> None:
        w = width * node.value / total
        if w < 0.4:
            return
        y = height - (level + 1) * _FRAME_H - 8
        color = _PALETTE[color_idx % len(_PALETTE)]
        pct = 100.0 * node.value / total
        label = escape(node.name)
        parts.append(
            f'<g><title>{label} ({node.value} samples, {pct:.1f}%)</title>'
            f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" height="{_FRAME_H - 1}"'
            f' fill="{color}" rx="1"/>'
        )
        if w > 40:
            chars = max(1, int(w / (_FONT_SIZE * 0.62)) - 1)
            parts.append(
                f'<text x="{x + 3:.1f}" y="{y + _FRAME_H - 5}"'
                f' fill="#1a1a1a">{label[:chars]}</text>'
            )
        parts.append("</g>")
        child_x = x
        for i, name in enumerate(sorted(node.children)):
            child = node.children[name]
            emit(child, child_x, level + 1, color_idx + i + 1)
            child_x += width * child.value / total

    emit(root, 0.0, 0, 0)
    parts.append("</svg>")
    return "\n".join(parts)


def _diff_color(delta_pct: float) -> str:
    """flamegraph.pl --negate palette: red = grew vs base, blue = shrank,
    grey = within noise; intensity scales with the delta."""
    if abs(delta_pct) < 0.05:
        return "#c9c9c9"
    mag = min(1.0, abs(delta_pct) / 5.0)  # saturate at a 5-point swing
    fade = int(220 - 150 * mag)
    if delta_pct > 0:
        return f"#ff{fade:02x}{fade:02x}"
    return f"#{fade:02x}{fade:02x}ff"


def flamegraph_diff_svg(
    base_lines: Iterable[str],
    new_lines: Iterable[str],
    title: str = "mysticeti-tpu flame diff",
    width: int = 1200,
) -> str:
    """A/B flame diff: layout follows the NEW profile (x = fraction of new
    samples) and color encodes the per-frame share delta vs the base —
    red frames grew, blue shrank, grey held.  Frames present only in the
    base vanish from the layout (they have zero new width); the summary
    row in the tooltip carries both shares for every surviving frame.
    """
    base_root = _build_trie(base_lines)
    new_root = _build_trie(new_lines)
    if new_root.value == 0:
        new_root.value = 1
    base_total = base_root.value or 1
    total = new_root.value
    height = (_depth(new_root) + 1) * _FRAME_H + 40
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}"'
        f' height="{height}" font-family="monospace" font-size="{_FONT_SIZE}">',
        f'<text x="{width // 2}" y="20" text-anchor="middle"'
        f' font-size="14">{escape(title)} (red grew / blue shrank)</text>',
    ]

    def emit(node: _Node, base: Optional[_Node], x: float, level: int) -> None:
        w = width * node.value / total
        if w < 0.4:
            return
        y = height - (level + 1) * _FRAME_H - 8
        new_pct = 100.0 * node.value / total
        base_pct = 100.0 * (base.value if base is not None else 0) / base_total
        delta = new_pct - base_pct
        label = escape(node.name)
        parts.append(
            f'<g><title>{label} ({new_pct:.1f}% vs {base_pct:.1f}% base, '
            f'{delta:+.1f} pts)</title>'
            f'<rect x="{x:.1f}" y="{y}" width="{w:.1f}" height="{_FRAME_H - 1}"'
            f' fill="{_diff_color(delta)}" rx="1"/>'
        )
        if w > 40:
            chars = max(1, int(w / (_FONT_SIZE * 0.62)) - 1)
            parts.append(
                f'<text x="{x + 3:.1f}" y="{y + _FRAME_H - 5}"'
                f' fill="#1a1a1a">{label[:chars]}</text>'
            )
        parts.append("</g>")
        child_x = x
        for name in sorted(node.children):
            child = node.children[name]
            base_child = base.children.get(name) if base is not None else None
            emit(child, base_child, child_x, level + 1)
            child_x += width * child.value / total

    emit(new_root, base_root, 0.0, 0)
    parts.append("</svg>")
    return "\n".join(parts)


def render_file(folded_path: str, svg_path: Optional[str] = None) -> str:
    """Render a folded file to SVG; returns the SVG path."""
    svg = flamegraph_svg(
        load_folded(folded_path), title=os.path.basename(folded_path)
    )
    out = svg_path or folded_path.rsplit(".", 1)[0] + ".svg"
    with open(out, "w") as f:
        f.write(svg)
    return out


def render_diff(
    base_path: str, new_path: str, svg_path: Optional[str] = None
) -> str:
    """Render an A/B flame diff of two folded files; returns the SVG path."""
    svg = flamegraph_diff_svg(
        load_folded(base_path),
        load_folded(new_path),
        title=f"{os.path.basename(base_path)} → {os.path.basename(new_path)}",
    )
    out = svg_path or new_path.rsplit(".", 1)[0] + ".diff.svg"
    with open(out, "w") as f:
        f.write(svg)
    return out


_active: Optional[SamplingProfiler] = None


def start_from_env() -> Optional[SamplingProfiler]:
    """Start lifetime profiling when ``MYSTICETI_PROFILE`` is set; the node
    CLI calls this at boot and :func:`stop_from_env` at shutdown."""
    global _active
    path = os.environ.get("MYSTICETI_PROFILE")
    if not path or _active is not None:
        return None
    # "%p" -> pid so one env var serves a whole local fleet without the
    # nodes clobbering each other's profiles.
    path = path.replace("%p", str(os.getpid()))
    _active = SamplingProfiler(
        flush_path=path, accountant=SubsystemAccountant()
    ).start()
    return _active


def bind_active(metrics, leaders_fn=None) -> None:
    """Bind the env-started sampler's accountant to a node's metrics (and
    committed-leader source).  No-op when profiling is off — the validator
    calls this unconditionally at health-plane boot."""
    if _active is not None and _active.accountant is not None:
        _active.accountant.bind(metrics, leaders_fn=leaders_fn)


def active_accountant() -> Optional[SubsystemAccountant]:
    return _active.accountant if _active is not None else None


def write_report_from_env() -> Optional[str]:
    """Write the attribution report when ``MYSTICETI_PERF_REPORT`` is set
    (atomic, %p-expanded); returns the path written."""
    path = os.environ.get("MYSTICETI_PERF_REPORT")
    if not path or _active is None or _active.accountant is None:
        return None
    path = path.replace("%p", str(os.getpid()))
    # The written file carries the native data-plane inventory alongside
    # the attribution numbers (A/B harnesses record which path the node
    # ran); report_bytes() itself stays environment-independent — the
    # seeded census pin in tests/test_torch_hostattr.py covers it, not this.
    doc = json.loads(_active.accountant.report_bytes())
    try:
        from .native import active_functions

        doc["native_active"] = list(active_functions())
    except Exception:  # noqa: BLE001 - inventory is best-effort evidence
        pass
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    os.replace(tmp, path)
    return path


def stop_from_env() -> None:
    global _active
    path = os.environ.get("MYSTICETI_PROFILE")
    if _active is None or not path:
        return
    path = path.replace("%p", str(os.getpid()))
    _active.stop()
    _active.write_folded(path)
    render_file(path)
    write_report_from_env()
    _active = None
