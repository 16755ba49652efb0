"""``tools.dataplane_split``'s middle arm and its readings.

The no-offload arm starts each node with a ``sitecustomize`` that raises
``DataPlaneOffload.MIN_BATCH_BYTES`` past any frame: a child started with
the arm's environment must see the raised bound and never offload, while
one started without it keeps the package's 16 KiB.  The summary divides
each arm's leaders by the fallback's.  A card kind's fleets verify through
``tools.ServiceChild``, the launcher ``chip_smoke.py``'s step 24 uses too.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.tools import REPO, ServiceChild
from mysticeti_tpu_torch.tools import dataplane_split as S

CHILD = ("import json\n"
         "from mysticeti_tpu_torch.core_task import DataPlaneOffload as D\n"
         "o = D()\n"
         "o._active = True\n"
         "print(json.dumps([D.MIN_BATCH_BYTES, o.should_offload(1 << 30)]))\n")


def _child(env):
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, **env), check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_middle_arm_never_offloads(tmp_path):
    assert S.arm_env("native", str(tmp_path)) == S.arm_env("fallback", str(tmp_path)) == {}
    assert _child(S.arm_env("native-no-offload", str(tmp_path))) == [1 << 62, False]
    assert _child({}) == [16 * 1024, True]


def test_thread_seconds_and_summary(tmp_path):
    for node, offload in enumerate((1.5, 0.5)):
        (tmp_path / f"validator-{node}").mkdir()
        (tmp_path / f"validator-{node}" / "perf_report.json").write_text(json.dumps(
            {"cpu_seconds": {"mesh-parse/loop": 2.0, "digest/offload": offload,
                             "other/verifier": 0.25}}))
    threads = S.thread_seconds(str(tmp_path))
    assert threads == {"loop": 4.0, "offload": 2.0, "verifier": 0.5}

    def reading(leaders, offload):
        return {"leaders_mean": leaders, "hotpath_us_per_leader": 10.0, "offload_cpu_s": offload,
                "cpu_s_by_thread_class": {"loop": 1.0, "verifier": 2.0},
                "gil_convoy_ratio": 0.5, "loop_lag": {"p50_s_mean": 0.001, "p99_s_mean": 0.01}}

    summary = S.summary_of({"native": [reading(50.0, 3.0), reading(70.0, 1.0)],
                            "native-no-offload": [reading(90.0, 0.0)],
                            "fallback": [reading(120.0, 0.0)]})
    assert summary["native"]["leaders_mean"] == 60.0
    assert summary["native"]["over_fallback"] == 0.5
    assert summary["native"]["offload_cpu_s"] == 4.0
    assert summary["native-no-offload"]["over_fallback"] == 0.75
    assert summary["fallback"]["over_fallback"] == 1.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="with a card the service warms")
def test_the_service_child_serves_the_benchmark_committee(tmp_path):
    """The launcher writes the fleets' genesis committee for the service;
    with no card here the service exits at its warm-up, and ``start``
    raises instead of waiting out its deadline."""
    service = ServiceChild(str(tmp_path / "svc"), 4)
    committee = Committee.load(str(tmp_path / "svc" / "committee.yaml"))
    assert committee.public_key_bytes() == Committee.new_for_benchmarks(4).public_key_bytes()
    try:
        with pytest.raises(RuntimeError, match="died or never warmed"):
            service.start(timeout_s=120.0)
        assert service.proc.returncode not in (None, 0)
    finally:
        service.stop()
    assert service.proc.poll() is not None
