"""Host-level metrics sampling — the node_exporter equivalent.

The port's copy of ``mysticeti_tpu.orchestrator.hostmon``.

The reference deploys a node_exporter container per instance and scrapes it
through the monitoring stack (``orchestrator/assets/install_node_exporter.sh``,
``orchestrator/src/monitor.rs:105-148``) so benchmark runs can attribute
saturation to the host, not just the node process.  Here the same capability
is a psutil sampler driven by the orchestrator's scrape loop:

* ``HostSampler.sample(pids)`` — system cpu%, 1-minute load, available
  memory, cumulative net bytes, plus per-node-process cpu%/rss/threads.
* Samples ride in the ``MeasurementsCollection`` (``host_samples``) and are
  summarized by ``MeasurementsCollection.host_summary()``, so max-load
  artifacts can tell verification cost from engine cost from load-generator
  core-steal on a shared box.

cpu_percent readings are interval-based: the sampler keeps one
``psutil.Process`` handle per pid so each call measures utilization since the
previous scrape; the first sample for a pid reports ``None`` (no interval yet)
rather than a misleading 0.0.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional


class HostSampler:
    def __init__(self) -> None:
        import psutil

        self._psutil = psutil
        self._procs: Dict[int, "psutil.Process"] = {}
        psutil.cpu_percent(None)  # seed the system-wide interval counter

    def sample(self, pids: Optional[Dict[str, int]] = None) -> dict:
        psutil = self._psutil
        per: Dict[str, dict] = {}
        for name, pid in (pids or {}).items():
            try:
                proc = self._procs.get(pid)
                if proc is None:
                    proc = psutil.Process(pid)
                    proc.cpu_percent(None)  # seed; no interval to report yet
                    self._procs[pid] = proc
                    cpu = None
                else:
                    cpu = proc.cpu_percent(None)
                with proc.oneshot():
                    per[name] = {
                        "cpu_pct": cpu,
                        "rss_mb": round(proc.memory_info().rss / 2**20, 1),
                        "threads": proc.num_threads(),
                    }
            except psutil.Error:
                self._procs.pop(pid, None)
        vm = psutil.virtual_memory()
        net = psutil.net_io_counters()
        load_1m, load_5m, load_15m = os.getloadavg()
        # CPU steal: time another guest on the hypervisor took from us —
        # on a shared cloud box it explains loop-lag spikes no in-process
        # attribution can (the GIL/host conditions a PERF_ATTR artifact
        # was measured under).
        steal = getattr(psutil.cpu_times_percent(None), "steal", None)
        return {
            "timestamp_s": time.time(),
            "cpu_pct": psutil.cpu_percent(None),
            "load_1m": load_1m,
            "load_5m": load_5m,
            "load_15m": load_15m,
            "cpu_steal_pct": steal,
            # The GIL release cadence the run was measured under: a tuned
            # sys.setswitchinterval changes every convoy/blocking number.
            "switch_interval_s": sys.getswitchinterval(),
            "mem_available_mb": round(vm.available / 2**20, 1),
            "net_bytes_sent": net.bytes_sent,
            "net_bytes_recv": net.bytes_recv,
            "per_process": per,
        }


REMOTE_SAMPLE_CMD = (
    "cat /proc/loadavg && grep -E 'MemTotal|MemAvailable' /proc/meminfo"
)


def parse_remote_sample(text: str) -> Optional[dict]:
    """Parse the ``REMOTE_SAMPLE_CMD`` output from an SshRunner host into the
    same shape as ``HostSampler.sample`` (fields that need interval state are
    absent — one ssh round-trip per scrape keeps the remote side stateless)."""
    try:
        lines = [ln for ln in text.splitlines() if ln.strip()]
        loads = lines[0].split()
        mem = {}
        for ln in lines[1:]:
            key, _, rest = ln.partition(":")
            mem[key.strip()] = float(rest.split()[0]) / 1024.0  # kB -> MB
        return {
            "timestamp_s": time.time(),
            "load_1m": float(loads[0]),
            "load_5m": float(loads[1]),
            "load_15m": float(loads[2]),
            "mem_available_mb": round(mem.get("MemAvailable", 0.0), 1),
            "mem_total_mb": round(mem.get("MemTotal", 0.0), 1),
        }
    except (IndexError, ValueError):
        return None
