"""No default of a port tool can touch a file that predates the port.

The JAX package's tools write their rounds at the repository root by
default (``STORAGE_r08.json``, ``KERNEL_PARITY.json``,
``MULTICHIP_SCALING.json``, ``BENCH_TREND.json`` ...).  Each port tool's
parser is captured as its ``main`` builds it; every string default (and
every module-level ``DEFAULT_*`` path) is resolved from the repository root
and must not name a file git tracks outside the port's package; every
output default must lie under ``build/``."""
import argparse
import importlib
import os
import pkgutil
import subprocess

import pytest

import mysticeti_tpu_torch.tools as tools_pkg
from mysticeti_tpu_torch.tools import BUILD_DIR, REPO

TOOLS = sorted(m.name for m in pkgutil.iter_modules(tools_pkg.__path__))
# The output and index options of the tools (their inputs are required
# arguments or default to None).
OUTPUTS = {"out", "repo", "working_dir", "workdir"}


class _Captured(Exception):
    pass


def _predating() -> set:
    """The tracked files that are not the port's own package (whose files,
    such as the lint's baseline, its tools may read by default)."""
    package = os.path.join(REPO, "mysticeti_tpu_torch") + os.sep
    return {p for p in _tracked() if not p.startswith(package)}


def _tracked() -> set:
    try:
        names = subprocess.run(["git", "ls-files"], cwd=REPO, capture_output=True, text=True,
                               check=True).stdout.split()
    except (OSError, subprocess.CalledProcessError):
        # Not a git checkout: every file outside build/ counts as tracked.
        names = [os.path.relpath(os.path.join(d, f), REPO)
                 for d, dirs, files in os.walk(REPO)
                 if not os.path.relpath(d, REPO).startswith(("build", ".git"))
                 for f in files]
    return {os.path.normpath(os.path.join(REPO, n)) for n in names}


def _parser(module):
    """The ``ArgumentParser`` that ``module.main`` builds, captured at its
    ``parse_args``."""
    captured = []

    def capture(self, *args, **kwargs):
        captured.append(self)
        raise _Captured

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        module.main([])
    except _Captured:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return captured[0] if captured else None


@pytest.mark.parametrize("name", TOOLS)
def test_no_default_names_a_tracked_file(name):
    module = importlib.import_module(f"mysticeti_tpu_torch.tools.{name}")
    tracked = _predating()
    defaults = {}
    parser = _parser(module) if hasattr(module, "main") else None
    if parser is not None:
        defaults.update({a.dest: a.default for a in parser._actions
                         if isinstance(a.default, str)})
    defaults.update({k: v for k, v in vars(module).items()
                     if k.startswith("DEFAULT_") and isinstance(v, str)})
    for key, value in defaults.items():
        path = os.path.normpath(os.path.join(REPO, value))
        assert path not in tracked, f"{name}: the default {key}={value!r} is a tracked file"
        if key in OUTPUTS or key in ("DEFAULT_OUT", "DEFAULT_INDEX", "DEFAULT_TREND_ARTIFACT"):
            assert path.startswith(BUILD_DIR + os.sep) or path == BUILD_DIR, (
                f"{name}: the output default {key}={value!r} lies outside build/")


def test_every_new_tool_has_its_parser_captured():
    for name in ("kernel_parity", "bench_probe", "mesh_scaling", "bench_trend", "wal_inspect",
                 "storage_probe", "commit_explain", "perf_attr", "scenario_matrix", "detsan",
                 "maxload_bench", "chip_window_ab", "node_bench", "catchup_bench",
                 "overload_bench", "dataplane_ab", "mesh_ab", "reconfig_matrix",
                 "finality_bench", "execution_bench"):
        assert name in TOOLS
        assert _parser(importlib.import_module(f"mysticeti_tpu_torch.tools.{name}")) is not None


def test_perf_attr_default_out_lies_under_build(monkeypatch):
    from mysticeti_tpu_torch.tools import perf_attr

    written = []
    monkeypatch.setattr(perf_attr, "run_fleet", lambda args: {
        "attributed_ratio": 1.0, "loop_lag": {"p99_s_max": 0.0}, "gil_convoy_ratio": 0.0,
        "device": {"occupancy_fractions": {}}, "subsystems": {}, "exit_codes": {}})
    monkeypatch.setattr(perf_attr, "write_json", lambda path, doc, **kw: written.append(path))
    assert perf_attr.main(["--no-trend"]) == 0
    assert perf_attr.main(["--no-trend", "--round", "14"]) == 0
    assert written == [os.path.join(BUILD_DIR, "PERF_ATTR.json"),
                       os.path.join(BUILD_DIR, "PERF_ATTR_r14.json")]
