"""The traced run's reading of the card: ``torch.profiler`` over the window,
exported as a Chrome trace inside the checkout, reduced to the device's busy
seconds, kernel seconds by name, and idle gaps labelled by what the host was
doing (the benchmark's own spans).

Host spans are taken on ``time.perf_counter``; one profiler annotation made
at a known host time ties that clock to the trace's.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_MARK = "perfbench.clock_sync"
# Which host span names an idle gap, when several are open at its middle.
GAP_PRIORITY = ("dispatch", "fetch", "stage1")
GAP_IDLE_HOST = "collector_wait"


class Spans:
    """Host intervals by name: (start, end) on ``time.perf_counter``."""

    def __init__(self) -> None:
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    def add(self, name: str, t0: float, t1: float) -> None:
        self.by_name[name].append((t0, t1))


class Profiler:
    """``torch.profiler`` over the window; ``stop`` returns the device's
    intervals on the host clock."""

    def __init__(self, path: str) -> None:
        import torch

        self.torch = torch
        self.path = path
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.sync_host = 0.0

    def start(self) -> None:
        self.prof.start()
        self.sync_host = time.perf_counter()
        with self.torch.profiler.record_function(SYNC_MARK):
            pass

    def stop(self) -> List[Tuple[str, str, float, float]]:
        self.torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(self.path)
        return device_intervals(events, self.sync_host)


def device_intervals(events, sync_host: float) -> List[Tuple[str, str, float, float]]:
    """(category, name, start, end) of every device operation, on the host
    clock, from Chrome trace events (``ts`` and ``dur`` in microseconds)."""
    sync_ts = next((e["ts"] for e in events if e.get("name") == SYNC_MARK and "ts" in e), None)
    if sync_ts is None:
        raise RuntimeError("the profiler trace lacks the clock mark")
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = sync_host + (float(e["ts"]) - float(sync_ts)) * 1e-6
            out.append((e["cat"], e.get("name", "?"), t0, t0 + float(e.get("dur", 0.0)) * 1e-6))
    return out


def union(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Merged intervals clipped to [lo, hi]."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list or template arguments."""
    name = name[5:] if name.startswith("void ") else name
    return (name.split("(")[0].split("<")[0] if "(" in name else name)[:96].strip()


class _OpenSpans:
    """Which of the host spans was open at a time: each name's merged
    intervals, searched by bisection."""

    def __init__(self, spans: Spans) -> None:
        self.merged = {}
        for name in GAP_PRIORITY:
            iv = union(spans.by_name.get(name, []), float("-inf"), float("inf"))
            self.merged[name] = ([a for a, _ in iv], [b for _, b in iv])

    def at(self, t: float) -> str:
        for name in GAP_PRIORITY:
            starts, ends = self.merged[name]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ends[i]:
                return name
        return GAP_IDLE_HOST


def reduce(device, spans: Spans, lo: float, hi: float, top: int = 10) -> dict:
    """Busy and kernel seconds in [lo, hi], the top device operations, idle
    seconds by the host span open at each gap's middle, and the number and
    seconds of the dispatch spans that started in the window."""
    busy = union([(a, b) for _, _, a, b in device], lo, hi)
    kernels = union([(a, b) for cat, _, a, b in device if cat == "kernel"], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for _, name, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[short_name(name)] += b - a
    gaps: Dict[str, float] = defaultdict(float)
    open_spans = _OpenSpans(spans)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[open_spans.at((a + b) / 2)] += b - a
    dispatches = [(a, b) for a, b in spans.by_name.get("dispatch", []) if lo <= a < hi]
    return {
        "dispatches": len(dispatches),
        "dispatch_s": sum(b - a for a, b in dispatches),
        "busy_s": sum(b - a for a, b in busy),
        "kernel_s": sum(b - a for a, b in kernels),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:top],
    }
