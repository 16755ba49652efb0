"""The port's ``storage_probe`` against the JAX package's tool: with
``--verifier sim-oracle`` (the JAX tool's own run: its plans have no
adversaries, so no verifier) the port's document's deterministic fields
equal the JAX tool's at the same seeds, both tools run as users run them,
in children under one ``PYTHONHASHSEED`` (``chip_smoke.HASH_SEED``); and
the kernel kinds need a card."""
import json
import os
import subprocess
import sys

import pytest

from mysticeti_tpu_torch.tools import BUILD_DIR, storage_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.storage


def test_seeded_fields_equal_the_jax_tools(tmp_path):
    env = dict(os.environ, PYTHONHASHSEED=chip_smoke.HASH_SEED)
    port_out, jax_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    port = subprocess.Popen(
        [sys.executable, "-m", "mysticeti_tpu_torch.tools.storage_probe", "--quick",
         "--verifier", "sim-oracle", "--out", port_out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "storage_probe.py"), "--quick",
         "--out", jax_out],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for proc in (port, jax):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    ours, theirs = (json.loads(open(p).read()) for p in (port_out, jax_out))
    assert storage_probe.deterministic(ours) == storage_probe.deterministic(theirs)
    assert set(storage_probe.deterministic(ours)) == {"bounded_disk", "snapshot_catchup"}
    for key in ("probe", "revision", "quick", "config_defaults"):
        assert ours[key] == theirs[key]
    assert ours["verifier"] == "sim-oracle" and ours["card"] is None
    # The JAX tool's document keys, plus the port's verifier, card and launches.
    assert set(theirs) | {"verifier", "card"} == set(ours)
    for name in ("bounded_disk", "snapshot_catchup"):
        assert set(theirs[name]) | {"launches"} == set(ours[name])
        assert ours[name]["pass"]


def test_one_scenario_alone(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(storage_probe, "bounded_disk_scenario",
                        lambda quick, verifier: calls.append("disk") or {"pass": True})
    monkeypatch.setattr(storage_probe, "snapshot_catchup_scenario",
                        lambda quick, verifier: calls.append("catchup") or {"pass": True})
    out = str(tmp_path / "s.json")
    assert storage_probe.main(["--quick", "--verifier", "sim-oracle", "--scenario",
                               "bounded-disk", "--out", out]) == 0
    doc = json.loads(open(out).read())
    assert calls == ["disk"] and "snapshot_catchup" not in doc
    assert storage_probe.deterministic(doc) == {"bounded_disk": {"pass": True}}


def test_default_out_lies_under_build():
    assert storage_probe.DEFAULT_OUT == os.path.join(BUILD_DIR, "STORAGE_r08.json")


def test_the_kernel_kinds_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storage_probe.verifier_kwargs("cuda-only")
