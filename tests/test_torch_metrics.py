"""The port's metrics held to ``tests/test_metrics.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): the precise histograms' windows and
reservoir, ``report_precise``, the scrape's whole reference inventory
(``metrics.rs:36-87``, as PARITY.md maps it) and ``/healthz`` beside
``/metrics``.  Beyond it, the same seeded observations (single and
batched, across drained windows, past the reservoir's cap) must give the
JAX package's samples, percentiles and averages, and the published
percentile gauges must read the same.
"""
import random

import numpy as np
import pytest

from mysticeti_tpu import metrics as JM
from mysticeti_tpu_torch import metrics as PM
from torch_reference import suite_on_port

globals().update(suite_on_port("test_metrics.py"))

PCTS = (50, 90, 99)


def histogram_trace(metrics, seed):
    rng = random.Random(seed)
    h = metrics.PreciseHistogram(max_samples=500)
    out = []
    for window in range(4):
        level = rng.choice((0.1, 1.0, 5.0))
        for _ in range(rng.randrange(1, 4)):
            if rng.random() < 0.5:
                for _ in range(rng.randrange(100, 1500)):
                    h.observe(level + rng.random())
            else:
                n = rng.randrange(100, 1500)
                h.observe_many(np.array([level + rng.random() for _ in range(n)]))
        out.append((h.pcts(PCTS), h.avg(), h.count, list(h.samples)))
        h.clear()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_precise_histogram_as_the_jax_package(seed):
    assert histogram_trace(PM, seed) == histogram_trace(JM, seed)


def report_trace(metrics, seed):
    rng = random.Random(seed)
    m = metrics.Metrics()
    names = sorted(m._precise)
    out = []
    for window in range(3):
        for name in rng.sample(names, k=3):
            for _ in range(rng.randrange(1, 300)):
                m._precise[name].observe(rng.random() * (window + 1))
        m.report_precise()
        out.append({(name, str(p)): m._pct_gauge.labels(name, str(p))._value.get()
                    for name in names for p in PCTS})
    return names, out


@pytest.mark.parametrize("seed", range(2))
def test_published_percentiles_as_the_jax_package(seed):
    assert report_trace(PM, seed) == report_trace(JM, seed)
