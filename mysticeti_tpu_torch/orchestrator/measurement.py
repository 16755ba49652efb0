"""Prometheus scrape parsing and benchmark aggregation.

The port's copy of ``mysticeti_tpu.orchestrator.measurement``.

Capability parity with ``orchestrator/src/measurement.rs``:

* ``Measurement.from_prometheus`` (:45-106) — extract the benchmark-defining
  series {buckets, sum, count, squared_sum} for a workload label plus
  ``benchmark_duration``.
* throughput = count / duration (:109-117); average latency = sum/count;
  stdev = sqrt(squared_sum/count - avg^2) (:121-142).
* ``MeasurementsCollection`` (:163-281) — per-scraper time series, aggregation
  across validators, JSON save/load, display summary (:283-360).
"""
from __future__ import annotations

import json
import math
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_RE_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([0-9.eE+-]+|NaN)")


def _labels(raw: Optional[str]) -> Dict[str, str]:
    if not raw:
        return {}
    out = {}
    for part in raw.strip("{}").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k] = v.strip('"')
    return out


def iter_series(text: str):
    """Parse prometheus exposition text into ``(name, labels, value)``
    tuples — the one scrape parser the fleet health plane (``health.py``)
    shares."""
    for line in text.splitlines():
        match = _RE_LINE.match(line)
        if not match:
            continue
        name, raw_labels, raw_value = match.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        yield name, _labels(raw_labels), value


@dataclass
class Measurement:
    """One scrape's benchmark numbers for one workload label."""

    timestamp_s: float = 0.0
    benchmark_duration_s: float = 0.0
    buckets: Dict[str, float] = field(default_factory=dict)
    sum_s: float = 0.0
    count: int = 0
    squared_sum_s: float = 0.0

    @classmethod
    def from_prometheus(cls, text: str, workload: str = "shared") -> "Measurement":
        m = cls(timestamp_s=time.time())
        for name, labels, value in iter_series(text):
            if name == "benchmark_duration_total" or name == "benchmark_duration":
                m.benchmark_duration_s = value
            elif labels.get("workload") != workload:
                continue
            elif name == "latency_s_bucket":
                m.buckets[labels.get("le", "")] = value
            elif name == "latency_s_sum":
                m.sum_s = value
            elif name == "latency_s_count":
                m.count = int(value)
            elif name in ("latency_squared_s_total", "latency_squared_s"):
                m.squared_sum_s = value
        return m

    def tps(self) -> float:
        if self.benchmark_duration_s == 0:
            return 0.0
        return self.count / self.benchmark_duration_s

    def avg_latency_s(self) -> float:
        return self.sum_s / self.count if self.count else 0.0

    def stdev_latency_s(self) -> float:
        """sqrt(E[X^2] - E[X]^2) (measurement.rs:121-142)."""
        if not self.count:
            return 0.0
        first = self.squared_sum_s / self.count
        second = self.avg_latency_s() ** 2
        return math.sqrt(max(0.0, first - second))

    def to_dict(self) -> dict:
        return {
            "timestamp_s": self.timestamp_s,
            "benchmark_duration_s": self.benchmark_duration_s,
            "buckets": self.buckets,
            "sum_s": self.sum_s,
            "count": self.count,
            "squared_sum_s": self.squared_sum_s,
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "Measurement":
        return cls(**raw)


class MeasurementsCollection:
    """Per-scraper measurement series + cross-validator aggregation
    (measurement.rs:163-360)."""

    def __init__(self, parameters: Optional[dict] = None) -> None:
        self.parameters = parameters or {}
        self.scrapers: Dict[str, List[Measurement]] = {}
        # Host-level series (node_exporter equivalent, hostmon.py): one
        # sample per scrape tick, so saturation is attributable to the host
        # (core-steal between co-located validators) and not just the node.
        self.host_samples: List[dict] = []
        # Fleet health timeline (health.cluster_snapshot per scrape tick):
        # every perf artifact ships with its own diagnosis — quorum
        # participation, stragglers, commit skew, SLO alerts.
        self.health_samples: List[dict] = []

    def add(self, scraper_id: str, measurement: Measurement) -> None:
        self.scrapers.setdefault(scraper_id, []).append(measurement)

    def add_host_sample(self, sample: dict) -> None:
        self.host_samples.append(sample)

    def add_health_sample(self, sample: dict) -> None:
        self.health_samples.append(sample)

    def _last_measurements(self) -> List[Measurement]:
        return [series[-1] for series in self.scrapers.values() if series]

    def benchmark_duration(self) -> float:
        last = self._last_measurements()
        return max((m.benchmark_duration_s for m in last), default=0.0)

    def aggregate_tps(self) -> float:
        """MAX of per-validator tps over the common duration
        (measurement.rs:236-250 takes ``.map(tps).max()``): every validator
        observes every committed shared tx, so per-scraper counts are N
        views of the same total — summing them would report N× the system
        throughput."""
        duration = self.benchmark_duration()
        if duration == 0:
            return 0.0
        return max(
            (m.count / duration for m in self._last_measurements()), default=0.0
        )

    def aggregate_average_latency_s(self) -> float:
        """Mean of per-validator average latencies (measurement.rs:253-262)."""
        last = [m for m in self._last_measurements() if m.count]
        if not last:
            return 0.0
        return sum(m.avg_latency_s() for m in last) / len(last)

    def aggregate_stdev_latency_s(self) -> float:
        """MAX of per-validator latency stdevs (measurement.rs:265-272)."""
        return max(
            (m.stdev_latency_s() for m in self._last_measurements()), default=0.0
        )

    def host_summary(self) -> Optional[dict]:
        """Aggregate the host series: system cpu avg/max, per-process cpu
        averages, net throughput over the sampled span.  None without
        samples (e.g. a runner that cannot observe its hosts)."""
        samples = self.host_samples
        if not samples:
            return None
        # SshRunner samples nest per-host dicts under "hosts" (one fleet
        # sample covers N machines); flatten them into the same stream so the
        # aggregation below reads both shapes.
        flat: List[dict] = []
        for s in samples:
            if "hosts" in s:
                flat.extend(s["hosts"].values())
            else:
                flat.append(s)
        n_raw = len(samples)
        samples = flat
        cpu = [s["cpu_pct"] for s in samples if s.get("cpu_pct") is not None]
        per: Dict[str, List[float]] = {}
        for s in samples:
            for name, p in (s.get("per_process") or {}).items():
                if p.get("cpu_pct") is not None:
                    per.setdefault(name, []).append(p["cpu_pct"])
        out: dict = {"samples": n_raw}
        if cpu:
            out["cpu_pct_avg"] = round(sum(cpu) / len(cpu), 1)
            out["cpu_pct_max"] = round(max(cpu), 1)
        loads = [s["load_1m"] for s in samples if "load_1m" in s]
        if loads:
            out["load_1m_max"] = round(max(loads), 2)
        if per:
            out["per_process_cpu_pct_avg"] = {
                k: round(sum(v) / len(v), 1) for k, v in sorted(per.items())
            }
        span = samples[-1].get("timestamp_s", 0) - samples[0].get(
            "timestamp_s", 0
        )
        if span > 0 and "net_bytes_recv" in samples[-1]:
            out["net_recv_mb_s"] = round(
                (samples[-1]["net_bytes_recv"] - samples[0]["net_bytes_recv"])
                / span / 2**20,
                2,
            )
            out["net_sent_mb_s"] = round(
                (samples[-1]["net_bytes_sent"] - samples[0]["net_bytes_sent"])
                / span / 2**20,
                2,
            )
        return out

    def health_summary(self) -> Optional[dict]:
        """Aggregate the health timeline: the run's worst moments plus the
        final snapshot — enough for an artifact reader to judge whether a
        perf number was taken on a healthy fleet without replaying the
        whole timeline.  None when the health plane never sampled."""
        samples = self.health_samples
        if not samples:
            return None
        last = samples[-1]
        alert_totals: Dict[str, float] = dict(
            last.get("slo_alert_totals") or {}
        )
        return {
            "samples": len(samples),
            "final_status": last.get("status"),
            "quorum_participation_min": min(
                s.get("quorum_participation", 0.0) for s in samples
            ),
            "commit_skew_rounds_max": max(
                s.get("commit_skew_rounds", 0) for s in samples
            ),
            "unreachable_ticks": sum(
                1 for s in samples if s.get("unreachable")
            ),
            "slo_alert_totals": alert_totals,
            "worst_straggler": max(
                (
                    (lag, a)
                    for s in samples
                    for a, lag in (s.get("straggler_score") or {}).items()
                ),
                default=None,
            ),
        }

    def save(self, path: str) -> None:
        data = {
            "parameters": self.parameters,
            "scrapers": {
                k: [m.to_dict() for m in v] for k, v in self.scrapers.items()
            },
            "host_samples": self.host_samples,
            "health_samples": self.health_samples,
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "MeasurementsCollection":
        with open(path) as f:
            raw = json.load(f)
        c = cls(raw.get("parameters"))
        for k, series in raw.get("scrapers", {}).items():
            c.scrapers[k] = [Measurement.from_dict(m) for m in series]
        c.host_samples = raw.get("host_samples", [])
        c.health_samples = raw.get("health_samples", [])
        return c

    def display_summary(self) -> str:
        lines = [
            "Benchmark summary",
            "-----------------",
            f" duration:      {self.benchmark_duration():.0f} s",
            f" tps:           {self.aggregate_tps():.0f} tx/s",
            f" avg latency:   {self.aggregate_average_latency_s() * 1000:.0f} ms",
            f" stdev latency: {self.aggregate_stdev_latency_s() * 1000:.0f} ms",
        ]
        host = self.host_summary()
        if host and "cpu_pct_avg" in host:
            lines.append(
                f" host cpu:      {host['cpu_pct_avg']:.0f}% avg /"
                f" {host['cpu_pct_max']:.0f}% max"
            )
        health = self.health_summary()
        if health is not None:
            alerts = sum(health["slo_alert_totals"].values())
            lines.append(
                f" fleet health:  {health['final_status']} "
                f"(participation >= {health['quorum_participation_min']:.2f},"
                f" commit skew <= {health['commit_skew_rounds_max']},"
                f" {alerts:.0f} SLO alert(s))"
            )
        return "\n".join(lines)
