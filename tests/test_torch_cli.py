"""The port's node CLI (``python -m mysticeti_tpu_torch``), its metrics
reporter and its node-a-process attribution probe, against the JAX
package's.

``benchmark-genesis`` writes the JAX CLI's files byte for byte; the parser's
subcommands, flags and defaults are the JAX parser's with the verifier
kinds mapped (``tpu`` -> ``cuda``, ``tpu-only`` -> ``cuda-only``, ``tpu-agg``
-> ``cuda-agg``) and ``cuda-only`` the default; ``testbed`` commits;
``run --verifier cuda-only`` exits non-zero with no card, and a node whose
kernels fail to build stops with an error; ``tools.perf_attr`` boots a
4-node fleet a node a process; ``report_precise`` publishes the JAX
package's ``histogram_pct`` lines; and ``chip_smoke.py``'s node phase runs in
small on the ``cpu`` kind.  Fleets use ports of the kernel's choosing, never
the fixed ``benchmark-genesis`` ports another test may hold.
"""
import argparse
import filecmp
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from mysticeti_tpu_torch import cli
from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.config import Identifier, Parameters
from mysticeti_tpu_torch.metrics import MetricReporter, Metrics
from mysticeti_tpu_torch.tools import perf_attr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIND_MAP = {"tpu": "cuda", "tpu-only": "cuda-only", "tpu-agg": "cuda-agg"}
NODE_SUBCOMMANDS = ("benchmark-genesis", "run", "dry-run", "testbed", "verifier-service")
SIM_SUBCOMMANDS = ("chaos", "overload", "scenarios")
ORCHESTRATOR_SUBCOMMANDS = ("orchestrator", "fleet")


def _free_port_base(n):
    """A base with ``base+i`` and ``base+1000+i`` free for ``i < n``."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 39000)
        try:
            socks = []
            for port in [base + i for i in range(n)] + [base + 1000 + i for i in range(n)]:
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def _genesis(wd, n):
    """The CLI's genesis for ``n`` nodes on 127.0.0.1, on free ports."""
    base = _free_port_base(n)
    parameters = Parameters.new_for_benchmarks(["127.0.0.1"] * n)
    parameters.identifiers = [Identifier("127.0.0.1", base + i, base + 1000 + i)
                              for i in range(n)]
    cli.benchmark_genesis(["127.0.0.1"] * n, wd, node_parameters=parameters)
    return parameters


def test_benchmark_genesis_files_equal_the_jax_clis(tmp_path):
    from mysticeti_tpu.cli import benchmark_genesis as jax_genesis

    ips = ["10.0.0.1", "10.0.0.2", "10.0.0.3", "10.0.0.4"]
    jax_genesis(ips, str(tmp_path / "jax"))
    assert cli.main(["benchmark-genesis", "--ips", *ips, "--working-directory",
                     str(tmp_path / "port")]) == 0
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert "committee.yaml" in files and "validator-3/seed" in files
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                           for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    for name in files:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False), name


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, as its ``main`` builds it."""
    from mysticeti_tpu import cli as jax_cli

    class Built(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Built(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Built) as built:
        jax_cli.main([])
    monkeypatch.undo()
    return built.value.args[0]


def _subcommands(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _flags(subparser, kinds=None):
    out = {}
    for action in subparser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        choices = action.choices
        default = action.default
        if kinds is not None and action.dest == "verifier":
            choices = [KIND_MAP.get(c, c) for c in choices]
            default = "cuda-only"
        out[action.dest] = (tuple(action.option_strings), default,
                            tuple(choices) if choices else None, action.required,
                            action.type, action.nargs, action.const)
    return out


def test_parser_equals_the_jax_clis_with_the_kinds_mapped(monkeypatch):
    jax = _subcommands(_jax_parser(monkeypatch))
    port = _subcommands(cli.build_parser())
    subcommands = NODE_SUBCOMMANDS + SIM_SUBCOMMANDS + ORCHESTRATOR_SUBCOMMANDS
    assert tuple(port) == subcommands
    assert set(subcommands) == set(jax)
    device = (("--device",), None, None, False, None, None, None)
    for name in subcommands:
        want = _flags(jax[name], kinds=KIND_MAP)
        if name == "verifier-service":
            # The port's service also takes the backend's torch device.
            want["device"] = device
        if name in ("chaos", "scenarios"):
            # The simulator's nodes verify through a port kind (the card's
            # by default) or the JAX CLI's own choice, ``sim-oracle``.
            want["verifier"] = (("--verifier",), "cuda-only",
                                tuple(cli.VERIFIER_CHOICES) + ("sim-oracle",), False, None,
                                None, None)
            want["device"] = device
        assert _flags(port[name]) == want, name
    verifier = _flags(port["run"])["verifier"]
    assert verifier[1] == "cuda-only" == cli.DEFAULT_VERIFIER
    assert verifier[2] == ("accept", "cpu", "cuda", "cuda-only", "cpu-agg", "cuda-agg")


def test_help_lists_the_node_subcommands():
    out = subprocess.run([sys.executable, "-m", "mysticeti_tpu_torch", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    for name in NODE_SUBCOMMANDS:
        assert name in out.stdout


def test_testbed_commits_on_every_node(tmp_path, monkeypatch, capsys):
    """``testbed --committee-size 4 --verifier cpu``: every node commits."""
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", _free_port_base(4))
    # The nodes start one after another and dial with backoff: commits begin
    # ~4.5 s in.
    assert cli.main(["testbed", "--committee-size", "4", "--verifier", "cpu", "--duration",
                     "7", "--working-directory", str(tmp_path / "tb")]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("validator ")]
    assert len(lines) == 4
    assert all(int(line.split()[2]) > 0 for line in lines), lines


def test_run_cuda_only_exits_non_zero_without_a_card(tmp_path):
    """``run`` with the default kind (``cuda-only``) and no card visible."""
    wd = str(tmp_path / "g")
    _genesis(wd, 4)
    out = subprocess.run(
        [sys.executable, "-m", "mysticeti_tpu_torch", "run", "--authority", "0",
         "--committee-path", os.path.join(wd, "committee.yaml"),
         "--parameters-path", os.path.join(wd, "parameters.yaml"),
         "--private-config-path", os.path.join(wd, "validator-0")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device available" in out.stderr


@pytest.mark.parametrize("command", ["run", "testbed"])
def test_run_stops_with_an_error_when_the_kernels_fail_to_build(tmp_path, monkeypatch, command):
    """A ``cuda-only`` node whose verifier warm-up raises (a kernel that does
    not build) stops and raises out of ``main``: it never carries on, alone
    (``run``) or in an in-process fleet (``testbed``, which stops every node
    first)."""
    from mysticeti_tpu_torch import block_validator as bv
    from mysticeti_tpu_torch.ops import cuda_build
    from mysticeti_tpu_torch.ops import ed25519
    from mysticeti_tpu_torch.validator import Validator

    def broken(self):
        raise cuda_build.CudaBuildError("nvcc failed on verify_keyed.cu")

    monkeypatch.setattr(ed25519, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(bv.TorchSignatureVerifier, "warmup", broken)
    monkeypatch.setenv("MYSTICETI_EXIT_AFTER", "60")
    wd = str(tmp_path / "g")
    if command == "run":
        _genesis(wd, 4)
        argv = ["run", "--authority", "0", "--committee-path", os.path.join(wd, "committee.yaml"),
                "--parameters-path", os.path.join(wd, "parameters.yaml"),
                "--private-config-path", os.path.join(wd, "validator-0")]
    else:
        monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", _free_port_base(4))
        argv = ["testbed", "--committee-size", "4", "--duration", "60",
                "--working-directory", wd]
    stopped = []
    stop = Validator.stop

    async def counted_stop(self):
        stopped.append(self)
        await stop(self)

    monkeypatch.setattr(Validator, "stop", counted_stop)
    with pytest.raises(RuntimeError, match="cuda-only verifier failed to warm up") as failed:
        cli.main(argv)
    assert isinstance(failed.value.__cause__, cuda_build.CudaBuildError)
    assert len(stopped) == (1 if command == "run" else 4)


def test_perf_attr_boots_a_node_a_process_fleet(tmp_path):
    """The port's ``perf_attr`` at n = 4 on the ``cpu`` kind, 12 s (commits
    begin ~4.5 s after the last node starts, as the nodes dial each other
    with backoff): every node exits 0 and writes its attribution report,
    and the artifact holds the fleet's account."""
    out = tmp_path / "PERF_ATTR.json"
    rc = perf_attr.main(["--committee-size", "4", "--duration", "12", "--verifier", "cpu",
                         "--working-dir", str(tmp_path / "fleet"), "--scrape-interval", "2",
                         "--port-base", str(_free_port_base(4)), "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["exit_codes"] == {str(a): 0 for a in range(4)}
    assert doc["reports_written"] == 4 and doc["scraped_nodes"] == 4
    assert all(leaders > 0 for leaders in doc["committed_leaders_by_node"].values())
    assert "verifier-pack" in doc["subsystems"] and doc["attributed_ratio"] > 0
    # psutil is installed here, so the host-weather block rides along.
    assert doc["weather"]["load_1m"] >= 0 and "per_process" not in doc["weather"]


def test_perf_attr_host_weather_block(monkeypatch):
    """The JAX tool's host-weather block: one ``HostSampler`` sample less its
    per-process part, the same keys as the JAX package's sampler; without
    psutil the document goes without it."""
    import builtins

    from mysticeti_tpu.orchestrator.hostmon import HostSampler as JaxHostSampler

    weather = perf_attr.host_weather()
    assert set(weather) == set(JaxHostSampler().sample()) - {"per_process"}
    assert weather["mem_available_mb"] > 0 and weather["switch_interval_s"] > 0
    real_import = builtins.__import__

    def no_psutil(name, *args, **kwargs):
        if name == "psutil":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_psutil)
    assert perf_attr.host_weather() is None


def test_perf_attr_refuses_ports_in_use(tmp_path):
    base = _free_port_base(2)
    held = socket.socket()
    held.bind(("127.0.0.1", base + 1001))
    held.listen()
    try:
        with pytest.raises(RuntimeError, match=f"ports already in use .*{base + 1001}"):
            perf_attr.write_genesis(str(tmp_path / "g"), 2, base)
    finally:
        held.close()


def test_metric_reporter_final_sweep_publishes_tail_window():
    metrics = Metrics()
    metrics.transaction_committed_latency.observe(0.25)
    reporter = MetricReporter(metrics, interval_s=3600.0)
    reporter.stop(final=True)  # never started: stop must still publish
    text = metrics.expose().decode()
    assert 'histogram_pct{name="transaction_committed_latency",pct="50"} 0.25' in text


@pytest.mark.parametrize("n", [1, 500, 120_000])
def test_report_precise_equals_the_jax_packages(n):
    """The same seeded observations (one at a time, then a batch past the
    reservoir's capacity) give the JAX package's ``histogram_pct`` lines,
    sweep after sweep (each drains the window), and the same cumulative
    averages."""
    from mysticeti_tpu import metrics as jax_metrics

    values = np.random.default_rng(n).exponential(0.5, n)

    def sweeps(module):
        m = module.Metrics()
        out = []
        for rnd in range(2):
            for v in values[: min(n, 300)]:
                m.transaction_committed_latency.observe(float(v))
                m.block_commit_latency.observe(float(v) * 2)
            m.transaction_certified_latency.observe_many(values + rnd)
            m.report_precise()
            out.append(sorted(line for line in m.expose().decode().splitlines()
                              if line.startswith("histogram_pct")))
            out.append(m.transaction_certified_latency.avg())
        return out

    port = sweeps(__import__("mysticeti_tpu_torch.metrics", fromlist=["Metrics"]))
    assert port == sweeps(jax_metrics)
    assert len(port[0]) == 9


def test_node_phase_in_small_on_the_cpu_kind(tmp_path):
    """``chip_smoke.node_fleet`` / ``node_checks`` at n = 4 on the ``cpu``
    kind, 10 s a node: every process exits 0, every node commits and the
    prefixes agree, the three routes answered, the final sweep, the
    shutdown dumps and the perf reports are there, no invalid block."""
    config = dict(chip_smoke.NODE_10, n=4, exit_after_s=10.0, port_base=_free_port_base(4),
                  min_commits=1, scrape_s=1.0)
    fleet = chip_smoke.node_fleet("node-cpu-4", "cpu", config, str(tmp_path))
    reading = chip_smoke.node_checks(fleet, config)
    assert min(reading["commits"]) >= 1 and reading["flushes"] > 0
    assert reading["torch_imported"] == 0 and reading["cuda_initialized"] == 0
    assert reading["committed_latency_p50_s"] is not None
    assert sum(reading["health"].values()) == 4
