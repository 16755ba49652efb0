"""Latency-throughput plots from measurement collections.

The port's copy of ``mysticeti_tpu.orchestrator.plot``.

Capability parity with ``orchestrator/assets/plot.py`` (:19-50): the classic
L-graph — aggregate throughput on x, average latency on y, one point per
benchmark run, one series per (nodes, faults) configuration — written as both
PNG and a plain-text data file so headless environments still get numbers.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Iterable, List

from .measurement import MeasurementsCollection


def _series_key(collection: MeasurementsCollection) -> str:
    p = collection.parameters or {}
    nodes = p.get("nodes", "?")
    faults = (p.get("faults") or {}).get("faults", 0)
    suffix = f" ({faults} faults)" if faults else ""
    return f"{nodes} nodes{suffix}"


def plot_latency_throughput(
    collections: Iterable[MeasurementsCollection],
    out_path: str,
) -> List[str]:
    """Write <out_path>.png (if matplotlib is usable) and <out_path>.txt.

    Returns the list of files written.
    """
    series = defaultdict(list)
    for c in collections:
        series[_series_key(c)].append(
            (c.aggregate_tps(), c.aggregate_average_latency_s())
        )
    for points in series.values():
        points.sort()

    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    written = []
    txt_path = out_path + ".txt"
    with open(txt_path, "w") as f:
        f.write("# series\ttps\tavg_latency_s\n")
        for name, points in sorted(series.items()):
            for tps, lat in points:
                f.write(f"{name}\t{tps:.1f}\t{lat:.4f}\n")
    written.append(txt_path)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return written

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, points in sorted(series.items()):
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        ax.plot(xs, ys, marker="o", label=name)
    ax.set_xlabel("throughput (tx/s)")
    ax.set_ylabel("avg latency (s)")
    ax.set_title("latency vs throughput")
    ax.grid(True, alpha=0.3)
    if series:
        ax.legend()
    png_path = out_path + ".png"
    fig.savefig(png_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(png_path)
    return written
