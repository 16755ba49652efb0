"""Prometheus scrape parsing.

The port's copy of the scrape parser of ``mysticeti_tpu.orchestrator.
measurement``: :func:`iter_series`, which ``health.cluster_snapshot_from_texts``
reads per-node ``/metrics`` texts with.  The benchmark aggregation around it
(``Measurement``, ``MeasurementsCollection``) comes with the port's
orchestrator.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

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
