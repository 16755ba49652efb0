"""Log analyzer: count errors/crashes in downloaded node and client logs.

The port's copy of ``mysticeti_tpu.orchestrator.logs``.

Capability parity with ``orchestrator/src/logs.rs`` (:10-56): after a
benchmark run, sweep the per-node log files and report how many log lines
look like errors and how many nodes crashed with a traceback — the quick
"did anything go wrong that the metrics won't show" check.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict

# Python-node equivalents of the reference's panic/error greps.
_ERROR_MARKERS = ("] error", "ERROR", " error ")
_CRASH_MARKERS = ("Traceback (most recent call last)",)


@dataclass
class LogsAnalysis:
    node_errors: Dict[str, int] = field(default_factory=dict)
    node_crashes: Dict[str, int] = field(default_factory=dict)

    @property
    def total_errors(self) -> int:
        return sum(self.node_errors.values())

    @property
    def total_crashes(self) -> int:
        return sum(self.node_crashes.values())

    def ok(self) -> bool:
        return self.total_errors == 0 and self.total_crashes == 0

    def display(self) -> str:
        lines = [
            f"log analysis: {self.total_errors} error lines, "
            f"{self.total_crashes} crashes across {len(self.node_errors)} logs"
        ]
        for name in sorted(self.node_errors):
            errors = self.node_errors[name]
            crashes = self.node_crashes[name]
            if errors or crashes:
                lines.append(f"  {name}: {errors} errors, {crashes} crashes")
        return "\n".join(lines)


def analyze_log_text(text: str) -> tuple:
    """(error_lines, crash_count) for one log's content."""
    errors = 0
    crashes = 0
    for line in text.splitlines():
        if any(m in line for m in _CRASH_MARKERS):
            crashes += 1
        elif any(m in line for m in _ERROR_MARKERS):
            errors += 1
    return errors, crashes


def analyze_logs(directory: str, pattern: str = "node-*.log") -> LogsAnalysis:
    """Sweep ``directory`` for log files matching ``pattern``."""
    analysis = LogsAnalysis()
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        name = os.path.basename(path)
        try:
            with open(path, "r", errors="replace") as f:
                errors, crashes = analyze_log_text(f.read())
        except OSError:
            continue
        analysis.node_errors[name] = errors
        analysis.node_crashes[name] = crashes
    return analysis
