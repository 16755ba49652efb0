"""Benchmark orchestration: deploy validators, drive load, scrape, summarize.

The port's copy of ``mysticeti_tpu.orchestrator``.  Its runners start the
port's node (``python -m mysticeti_tpu_torch run``) on the ``cuda-only`` kind
unless told otherwise.

Capability parity with the reference's ``orchestrator/`` crate, re-targeted:
the reference provisions AWS/Vultr over SSH (client/aws.rs, client/vultr.rs,
ssh.rs); this framework ships a provider-agnostic ``Runner`` seam with a fully
supported local multiprocess runner (the dry-run/testbed scale) and an
ssh-CLI-based runner for real fleets — no cloud SDK dependency.

Modules:
  measurement — prometheus scrape parsing + tps/latency aggregation
                (orchestrator/src/measurement.rs)
  benchmark   — benchmark parameters, fixed-load and max-load binary search
                (orchestrator/src/benchmark.rs)
  faults      — permanent / crash-recovery fault schedules
                (orchestrator/src/faults.rs)
  runner      — LocalProcessRunner + SshRunner (orchestrator.rs + ssh.rs)
  orchestrator— the benchmark lifecycle loop (orchestrator.rs:523-727)
  ssh         — retried/parallel remote execution manager (ssh.rs:83-446)
  testbed     — deploy/start/stop/destroy/status lifecycle + provider seam
                (testbed.rs:21-210, client/mod.rs:68)
  display     — colored progress/status/table console output (display.rs)
  settings    — persisted settings.json model (settings.rs:53-96)
  monitor     — prometheus/grafana monitoring stack deploy (monitor.rs)
  logs        — node/client log analyzer (logs.rs:10-56)
  plot        — latency-throughput plots (assets/plot.py)
"""
from .benchmark import BenchmarkParameters, LoadType, ParametersGenerator
from .faults import CrashRecoverySchedule, FaultsType
from .measurement import Measurement, MeasurementsCollection
from .ssh import CommandContext, SshManager
from .testbed import Instance, ServerProvider, StaticProvider, Testbed

__all__ = [
    "BenchmarkParameters",
    "LoadType",
    "ParametersGenerator",
    "FaultsType",
    "CrashRecoverySchedule",
    "Measurement",
    "MeasurementsCollection",
    "CommandContext",
    "SshManager",
    "Instance",
    "ServerProvider",
    "StaticProvider",
    "Testbed",
]
