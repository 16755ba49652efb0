"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's blocks are made from the seed (``traffic.py``) and handed as wire
bytes to one validator's block-receive path in ``mysticeti_tpu_torch``, as
``net_sync.NetworkSyncer`` drives it for each peer connection:

* stage 1: ``StatementBlock.from_bytes_many`` (on ``core_task.DataPlaneOffload``
  when the frame reaches its ``MIN_BATCH_BYTES``), then ``verify_structure``;
* stage 2: ``verify_blocks`` of the collector that
  ``validator._make_verifier("cuda-only", committee, metrics=Metrics())``
  builds, with up to ``NetworkSyncer.VERIFY_PIPELINE_DEPTH`` frames in
  flight a connection and verdicts taken in stream order.

The traffic is a catch-up: every peer's backlog drained by a fresh collector,
episode after episode, through the window.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (the readers in
``layer_metrics/``) and the device's busy seconds.  Once the window has
closed, ``check.py`` holds what the window produced to the plain reference;
every number compared is printed with its limit, last on standard error and
last in the result line.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
from array import array  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from .check import ACCEPTED, DROPPED, ERROR, PENDING, REJECTED  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "mysticeti_tpu")
# How long answers due in the window may come after it closed.
GRACE_S = 60.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The cell


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, config, mix, [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def load_reader(metric: str) -> Callable:
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# What a run records


class Records:
    """Each block handed to stage 1: its pool index, what stage 1 derived
    (author, round, block digest and signed digest) and the answer with its
    time, in columns that the garbage collector never scans (a run keeps
    ~10^5)."""

    def __init__(self) -> None:
        self.idx, self.author, self.round = array("q"), array("q"), array("q")
        self.t = array("d")
        self.outcome = bytearray()
        self.digests = bytearray()  # 64 B a block

    def add(self, idx: int, identity: Optional[tuple]) -> int:
        self.idx.append(idx)
        self.t.append(float("inf"))
        if identity is None:
            self.author.append(-1)
            self.round.append(-1)
            self.digests += bytes(64)
            self.outcome.append(DROPPED)
        else:
            self.author.append(identity[0])
            self.round.append(identity[1])
            self.digests += identity[2] + identity[3]
            self.outcome.append(PENDING)
        return len(self.outcome) - 1

    def answer(self, pos: int, outcome: int, t: float) -> None:
        self.outcome[pos] = outcome
        self.t[pos] = t

    def columns(self) -> dict:
        return {
            "idx": np.frombuffer(self.idx, np.int64).copy(),
            "author": np.frombuffer(self.author, np.int64).copy(),
            "round": np.frombuffer(self.round, np.int64).copy(),
            "t": np.frombuffer(self.t, np.float64).copy(),
            "outcome": np.frombuffer(bytes(self.outcome), np.uint8).copy(),
            "digests": np.frombuffer(bytes(self.digests), np.uint8).reshape(-1, 64).copy(),
        }


@dataclass
class Run:
    records: Records = field(default_factory=Records)
    stage1: List[tuple] = field(default_factory=list)  # (start, end, busy s, blocks) a frame
    episodes: List[dict] = field(default_factory=list)


class Receiver:
    """One validator's receive path over the program's objects."""

    def __init__(self, port, committee, metrics, verifier, pipeline_depth: int, spans) -> None:
        self.port = port
        self.committee = committee
        self.metrics = metrics
        self.verifier = verifier
        self.depth = pipeline_depth
        self.spans = spans
        self.offload = port.DataPlaneOffload(metrics=metrics)
        self.run = Run()

    def new_collector(self):
        """A collector as a restarted node has it: fresh state, same backend."""
        v = self.verifier
        if not isinstance(v, self.port.BatchedSignatureVerifier):
            return v
        return self.port.BatchedSignatureVerifier(
            self.committee, v.verifier, max_batch=v.max_batch, max_delay_s=v.max_delay_s,
            metrics=v.metrics, aggregate=v.aggregate, pipeline_depth=v.pipeline._fixed_depth)

    def _decode(self, raws):
        t0 = time.perf_counter()
        out = self.port.StatementBlock.from_bytes_many(raws)
        self.spans.add("stage1", t0, time.perf_counter())
        return t0, time.perf_counter(), out

    async def stage1(self, pool, idxs, keep: bool):
        raws = [pool.raws[i] for i in idxs]
        if self.offload.should_offload(sum(len(r) for r in raws)):
            t0, t1, decoded = await self.offload.run("decode", self._decode, raws)
        else:
            t0, t1, decoded = self._decode(raws)
        busy = t1 - t0
        t2 = time.perf_counter()
        blocks, positions = [], []
        for i, block in zip(idxs, decoded):
            if block is not None:
                try:
                    block.verify_structure(self.committee)
                except self.port.VerificationError:
                    block = None
            identity = None
            if block is not None:
                ref = block.reference
                identity = (ref.authority, ref.round, ref.digest, block.signed_digest())
                blocks.append(block)
            pos = self.run.records.add(i, identity) if keep else None
            if block is not None:
                positions.append(pos)
        t3 = time.perf_counter()
        self.spans.add("stage1", t2, t3)
        if keep:
            self.run.stage1.append((t0, t3, busy + t3 - t2, len(idxs)))
        return blocks, positions

    def stage2(self, collector, blocks, positions):
        fut = asyncio.ensure_future(collector.verify_blocks(blocks))
        records = self.run.records

        def done(f) -> None:
            if positions[0] is None:
                return
            t = time.perf_counter()
            if f.cancelled() or f.exception() is not None:
                for pos in positions:
                    records.answer(pos, ERROR, t)
                return
            for pos, ok in zip(positions, f.result()):
                records.answer(pos, ACCEPTED if ok else REJECTED, t)

        fut.add_done_callback(done)
        return fut

    async def connection(self, collector, inbox, pool, keep: bool) -> int:
        """One peer connection: frames from ``inbox`` (None ends it) through
        stage 1, then stage 2 with ``depth`` frames in flight, in order."""
        pipeline: asyncio.Queue = asyncio.Queue(maxsize=self.depth)

        async def accept() -> None:
            while (fut := await pipeline.get()) is not None:
                try:
                    await fut
                except Exception:  # noqa: BLE001 - recorded by stage2's callback
                    pass

        acceptor = asyncio.ensure_future(accept())
        sent = 0
        while (idxs := await inbox()) is not None:
            blocks, positions = await self.stage1(pool, idxs, keep)
            if blocks:
                sent += len(blocks)
                await pipeline.put(self.stage2(collector, blocks, positions))
        await pipeline.put(None)
        await acceptor
        return sent


def counters(metrics) -> Dict[str, float]:
    g = metrics.registry.get_sample_value
    out = {"lanes_sum": g("verify_dispatch_batch_size_sum") or 0.0,
           "lanes_count": g("verify_dispatch_batch_size_count") or 0.0}
    for stage in ("pack", "device", "fetch"):
        out[f"{stage}_s"] = g("verify_pipeline_stage_seconds_sum", {"stage": stage}) or 0.0
    return out


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


# ---------------------------------------------------------------------------
# The traffic


async def catchup_episode(rx: Receiver, pool, stop_at: float, keep: bool) -> dict:
    """Every peer's backlog, drained by a fresh collector; frames not started
    by ``stop_at`` are not sent.  Returns the episode's lane accounting."""
    collector = rx.new_collector()
    before = counters(rx.metrics)

    def inbox_of(frames):
        it = iter(frames)

        async def inbox():
            frame = next(it, None)
            if frame is None or time.perf_counter() >= stop_at:
                return None
            return frame

        return inbox

    sent = await asyncio.gather(*(rx.connection(collector, inbox_of(f), pool, keep)
                                  for f in pool.frames_by_peer))
    lanes = delta(before, counters(rx.metrics))["lanes_sum"]
    return {"sent": int(sum(sent)), "lanes": int(lanes)}


async def drive_catchup(rx: Receiver, pool, seconds: float, on_window: Callable) -> tuple:
    # One whole episode before the window warms every shape, thread and the
    # allocator's memory for the largest backlog in flight.
    await catchup_episode(rx, pool, float("inf"), keep=False)
    gc.collect()
    t0 = on_window("start")
    end = t0 + seconds
    loop = asyncio.get_running_loop()
    loop.call_at(loop.time() + seconds, on_window, "end")
    while time.perf_counter() < end:
        try:
            episode = await asyncio.wait_for(catchup_episode(rx, pool, end, keep=True),
                                             timeout=end - time.perf_counter() + GRACE_S)
        except asyncio.TimeoutError:  # answers still missing count as such
            break
        rx.run.episodes.append(episode)
    return t0, end


# ---------------------------------------------------------------------------
# Metrics


@dataclass
class Window:
    t0: float
    t1: float
    rec: dict  # Records.columns() of the blocks that count in the window
    stage1: List[tuple]
    counters: Dict[str, float]
    answered_in_window: int = 0  # verdicts given in [t0, t1]
    trace: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def blocks(self) -> int:
        return len(self.rec["outcome"])

    @property
    def answered(self) -> np.ndarray:
        return np.isin(self.rec["outcome"], (ACCEPTED, REJECTED))

    @property
    def failed(self) -> int:
        return int(np.isin(self.rec["outcome"], (PENDING, ERROR)).sum())

    @property
    def stage1_busy_s(self) -> float:
        return sum(busy for _, _, busy, _ in self.stage1)

    @property
    def stage1_blocks(self) -> int:
        return sum(n for *_, n in self.stage1)


def window_of(run: Run, t0: float, t1: float, ctrs: dict) -> Window:
    rec = run.records.columns()
    answered = np.isin(rec["outcome"], (ACCEPTED, REJECTED)) & (rec["t"] >= t0) & (rec["t"] <= t1)
    return Window(t0, t1, rec, run.stage1, ctrs, answered_in_window=int(answered.sum()))


def end_to_end(w: Window) -> Dict[str, float]:
    """Blocks that got a verdict in the window over its seconds: the
    catch-up drain's rate."""
    return {"catchup_blocks_per_s": w.answered_in_window / w.seconds}


# ---------------------------------------------------------------------------
# The run


def setup_env() -> None:
    """Every build and kernel cache of the program inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


class PortModules:
    """The names of ``mysticeti_tpu_torch`` the harness drives."""

    def __init__(self) -> None:
        from mysticeti_tpu_torch import crypto, validator
        from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
        from mysticeti_tpu_torch.committee import Authority, Committee
        from mysticeti_tpu_torch.core_task import DataPlaneOffload
        from mysticeti_tpu_torch.metrics import Metrics
        from mysticeti_tpu_torch.net_sync import NetworkSyncer
        from mysticeti_tpu_torch.types import StatementBlock, VerificationError

        self.crypto, self.validator = crypto, validator
        self.BatchedSignatureVerifier = BatchedSignatureVerifier
        self.Authority, self.Committee = Authority, Committee
        self.DataPlaneOffload, self.Metrics = DataPlaneOffload, Metrics
        self.pipeline_depth = NetworkSyncer.VERIFY_PIPELINE_DEPTH
        self.StatementBlock, self.VerificationError = StatementBlock, VerificationError


def make_committee(port, public_keys, epoch: int):
    return port.Committee([port.Authority(1, port.crypto.PublicKey(pk)) for pk in public_keys], epoch)


class TimedBackend:
    """Wraps the collector's backend in a traced run: host spans around the
    dispatch (inside the executor thread that submits it, so the executor's
    queue wait is not in it) and around waiting for its result."""

    def __init__(self, backend, spans) -> None:
        self._backend, self._spans = backend, spans

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def verify_signatures_async(self, *args):
        t0 = time.perf_counter()
        handle = self._backend.verify_signatures_async(*args)
        self._spans.add("dispatch", t0, time.perf_counter())
        return _TimedHandle(handle, self._spans)


class _TimedHandle:
    def __init__(self, handle, spans) -> None:
        self._handle, self._spans = handle, spans

    def __getattr__(self, name):
        return getattr(self._handle, name)

    def result(self):
        t0 = time.perf_counter()
        try:
            return self._handle.result()
        finally:
            self._spans.add("fetch", t0, time.perf_counter())


@dataclass
class Setup:
    """What a run builds before its traffic: keys, committee, the program's
    verifier and metrics, and the pool of blocks."""
    cell: Cell
    seed: int
    port: PortModules
    public_keys: list
    committee: object
    metrics: object
    verifier: object
    pool: object
    split: dict


def setup(cell: Cell, seed: int, kind: str = "cuda-only", device: Optional[str] = None) -> Setup:
    """``kind`` and ``device`` let the CPU tests drive the same path without a
    card; the benchmark runs the node's default, ``cuda-only`` on the card."""
    from . import traffic, wire

    port = PortModules()
    split = {"imports": time.perf_counter() - T_PROCESS}
    config = cell.config
    keys = wire.committee_keys(seed, int(config["committee_size"]))
    public_keys = wire.public_bytes(keys)
    committee = make_committee(port, public_keys, int(config.get("epoch", 0)))
    metrics = port.Metrics()
    verifier = port.validator._make_verifier(kind, committee, metrics=metrics, device=device)
    t = time.perf_counter()
    pool = traffic.build_pool(config, cell.mix, seed, keys)
    split["pool"] = time.perf_counter() - t
    log(f"pool: {len(pool.raws)} blocks, {pool.nbytes} B, {int(pool.forged.sum())} forged")
    t = time.perf_counter()
    verifier.ready.wait()
    split["verifier_after_pool"] = time.perf_counter() - t
    split["verifier_ready"] = time.perf_counter() - T_PROCESS
    return Setup(cell, seed, port, public_keys, committee, metrics, verifier, pool, split)


def measure(su: Setup, seconds: float, trace: bool, patch: Optional[Callable] = None) -> dict:
    """Warm up on the cell's own traffic, then measure for ``seconds``.
    ``patch`` is called with the receiver before any traffic (the control
    and the CPU tests' faults)."""
    from .trace import Profiler, Spans, reduce

    spans = Spans()
    rx = Receiver(su.port, su.committee, su.metrics, su.verifier, su.port.pipeline_depth, spans)
    profiler = None
    if trace:
        rx.verifier.verifier = TimedBackend(rx.verifier.verifier, spans)
        profiler = Profiler(str(BUILD / "perfbench" / f"trace-{os.getpid()}.json"))
    if patch is not None:
        patch(rx)
    marks: Dict[str, tuple] = {}

    def on_window(what: str) -> float:
        now = time.perf_counter()
        marks[what] = (now, counters(su.metrics))
        return now

    async def drive():
        if profiler is not None:
            profiler.start()
        return await drive_catchup(rx, su.pool, seconds, on_window)

    t_traffic = time.perf_counter()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way, the same in every run
    try:
        win0, win1 = asyncio.run(drive())
        if "end" not in marks:  # the last answer came before the timer fired
            on_window("end")
    finally:
        rx.offload.stop()
        if trace:
            rx.verifier.verifier = rx.verifier.verifier._backend
    device_ops = profiler.stop() if profiler is not None else None
    w = window_of(rx.run, win0, win1, delta(marks["start"][1], marks["end"][1]))
    if device_ops is not None:
        w.trace = reduce(device_ops, spans, win0, win1)
    su.split["traffic_before_window"] = marks["start"][0] - t_traffic
    return {"setup_s": marks["start"][0] - T_PROCESS, "window": w, "run": rx.run,
            "setup_split": dict(su.split)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, kind: str = "cuda-only",
             device: Optional[str] = None, patch: Optional[Callable] = None) -> dict:
    """One run as ``main`` prints it: set-up, window, then the comparison
    with the reference once the card's peak memory has been read."""
    from . import check

    su = setup(cell, seed, kind, device)
    out = measure(su, seconds, trace, patch)
    out["memory_peak_bytes"] = _memory_peak(device)
    t = time.perf_counter()
    out["checks"] = check.compare(su.pool, out["window"].rec, out["run"].episodes, su.public_keys,
                                  int(cell.config.get("epoch", 0)), seed)
    log(f"reference: {time.perf_counter() - t:.3f} s")
    return out


def _memory_peak(device) -> int:
    import torch

    if device == "cpu" or not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_allocated())


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    w: Window = out["window"]
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(w)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(w)
        values["setup_s"] = out["setup_s"]
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = out["checks"]
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": w.blocks,
        "failed": w.failed,
        "metrics": metrics,
        "device": device_info(out["memory_peak_bytes"]),
    }
    if trace:
        line["device"]["busy_s"] = w.trace["busy_s"]
        line["device"]["window_s"] = w.seconds
        line["breakdown"] = {"device_ops": w.trace["device_ops"], "idle_gaps": w.trace["idle_gaps"]}
    line["checks"] = checks
    return line


def per_second(w: Window) -> List[float]:
    """Verdicts in each second of the window (a diagnostic on standard
    error)."""
    return [float((w.answered & (w.rec["t"] >= w.t0 + k) & (w.rec["t"] < w.t0 + k + 1)).sum())
            for k in range(int(w.seconds))]


def device_info(memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": memory_peak_bytes}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_name_and_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    setup_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("no CUDA device: this benchmark measures the card and prints no result without one")
        return 2
    log(f"card: {card_name_and_limit()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: refused")
        return 3
    line = result_line(cell, out, bool(args.trace))
    w = out["window"]
    log("setup split s: " + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_split"].items()))
    log("per second: " + " ".join(f"{x:.1f}" for x in per_second(out["window"])))
    eps = out["run"].episodes
    log(f"window {w.seconds:.3f} s, {w.blocks} blocks; {len(eps)} episodes, "
        f"{sum(e['sent'] for e in eps)} blocks to stage 2, {sum(e['lanes'] for e in eps)} lanes")
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
