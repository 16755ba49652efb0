"""The port's orchestrator periphery: the log analyzer, the plot, settings,
the ``orchestrator`` / ``fleet`` CLI and the monitoring stack.

Counterparts of ``tests/test_orchestrator_periphery.py``, each output held to
the JAX package's where the function is pure.  The CLI's verifier default is
``cuda-only`` (the JAX CLI's is ``cpu``), and with no card that default
raises before any node starts.
"""
import asyncio
import importlib
import json
import os
import stat
import time

import pytest

from mysticeti_tpu_torch import cli
from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.orchestrator.logs import analyze_log_text, analyze_logs
from mysticeti_tpu_torch.orchestrator.plot import plot_latency_throughput
from mysticeti_tpu_torch.orchestrator.settings import Settings
from test_torch_cli import _free_port_base

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def _orch(pkg, name):
    return importlib.import_module(f"{pkg}.orchestrator.{name}")


def _write_logs(directory):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "node-0.log").write_text(
        "[00:00:01 A0] info validator: starting\n"
        "[00:00:02 A0] error net_sync: boom\n"
    )
    (directory / "node-1.log").write_text(
        "ok line\nTraceback (most recent call last):\n  File x\nValueError: y\n"
    )
    (directory / "node-2.log").write_text("ERROR x\n a error b\nfine\n")
    (directory / "other.log").write_text("ERROR not a node log\n")


def test_log_analyzer(tmp_path):
    _write_logs(tmp_path)
    analysis = analyze_logs(str(tmp_path))
    assert analysis.node_errors["node-0.log"] == 1
    assert analysis.node_crashes["node-1.log"] == 1
    assert not analysis.ok()
    assert "node-0.log" in analysis.display()
    assert analyze_log_text("all is well\n") == (0, 0)


def test_log_analysis_equals_the_jax_packages(tmp_path):
    _write_logs(tmp_path)
    got = []
    for pkg in PACKAGES:
        logs = _orch(pkg, "logs")
        a = logs.analyze_logs(str(tmp_path))
        got.append((a.node_errors, a.node_crashes, a.total_errors, a.total_crashes, a.ok(),
                    a.display(), logs.analyze_logs(str(tmp_path), "*.log").node_errors))
    assert got[0] == got[1]
    assert got[0][2] == 3


def _collection(nodes, load, tps, latency, pkg="mysticeti_tpu_torch", faults=0):
    measurement = _orch(pkg, "measurement")
    c = measurement.MeasurementsCollection(
        {"nodes": nodes, "load": load, "duration_s": 10.0,
         "faults": {"kind": "none" if not faults else "permanent", "faults": faults,
                    "interval_s": 60.0}}
    )
    n = int(tps * 10)
    c.add(
        "0",
        measurement.Measurement(
            timestamp_s=10.0,
            benchmark_duration_s=10.0,
            count=n,
            sum_s=latency * n,
            squared_sum_s=latency * latency * n,
        ),
    )
    return c


def test_plot_writes_txt_and_png(tmp_path):
    cols = [
        _collection(4, 100, 95.0, 0.2),
        _collection(4, 200, 180.0, 0.35),
    ]
    out = str(tmp_path / "lt")
    written = plot_latency_throughput(cols, out)
    assert out + ".txt" in written
    text = open(out + ".txt").read()
    assert "4 nodes" in text
    # matplotlib is available in this environment
    assert out + ".png" in written
    assert os.path.getsize(out + ".png") > 0


def test_plot_text_equals_the_jax_packages(tmp_path):
    texts = []
    for pkg in PACKAGES:
        cols = [_collection(4, 200, 180.0, 0.35, pkg), _collection(4, 100, 95.0, 0.2, pkg),
                _collection(10, 30000, 28000.5, 1.25, pkg),
                _collection(10, 10000, 9990.0, 0.8, pkg, faults=3)]
        out = str(tmp_path / pkg / "lt")
        plot_mod = _orch(pkg, "plot")
        assert plot_mod.plot_latency_throughput(cols, out)[0] == out + ".txt"
        texts.append(open(out + ".txt").read())
    assert texts[0] == texts[1]
    assert "10 nodes (3 faults)" in texts[0]


def test_plot_writes_only_the_txt_without_matplotlib(tmp_path, monkeypatch):
    """A host without matplotlib (the card's machine) still gets the numbers."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = str(tmp_path / "lt")
    assert plot_latency_throughput([_collection(4, 100, 95.0, 0.2)], out) == [out + ".txt"]
    assert not os.path.exists(out + ".png")


def test_settings_roundtrip(tmp_path):
    s = Settings(runner="local", working_dir="wd", tps_per_node=42)
    path = str(tmp_path / "settings.json")
    s.save(path)
    loaded = Settings.load(path)
    assert loaded == s
    runner = loaded.make_runner()
    assert runner.tps_per_node == 42
    assert runner.verifier == s.verifier == "cuda-only"  # the JAX package's: "cpu"

    bad = Settings(runner="ssh", hosts=[])
    with pytest.raises(ValueError):
        bad.validate()
    # Unknown keys in the file are tolerated (forward compatibility).
    with open(path, "w") as f:
        json.dump({"runner": "local", "future_field": 1}, f)
    assert Settings.load(path).runner == "local"


def test_settings_file_equals_the_jax_packages_but_the_verifier(tmp_path):
    texts = []
    for pkg in PACKAGES:
        s = _orch(pkg, "settings").Settings(runner="ssh", hosts=["u@h0"], verifier="cpu",
                                            provider_amis={"us-east-1": "ami-1"})
        path = tmp_path / f"{pkg}.json"
        s.save(str(path))
        texts.append(path.read_text())
    assert texts[0] == texts[1]
    defaults = [json.loads(json.dumps(
        __import__("dataclasses").asdict(_orch(pkg, "settings").Settings()))) for pkg in PACKAGES]
    assert defaults[0].pop("verifier") == "cpu" and defaults[1].pop("verifier") == "cuda-only"
    assert defaults[0] == defaults[1]


@pytest.mark.parametrize("command", ["orchestrator", "fleet"])
def test_orchestrator_cli_parses(command, capsys):
    """--help for the subcommand exits 0 (argparse raises SystemExit)."""
    with pytest.raises(SystemExit) as exc:
        cli.main([command, "--help"])
    assert exc.value.code == 0
    assert f"usage: mysticeti-tpu-torch {command}" in capsys.readouterr().out


def test_orchestrator_cli_defaults_to_the_card():
    args = cli.build_parser().parse_args(["orchestrator"])
    assert args.verifier == cli.DEFAULT_VERIFIER == "cuda-only"
    assert cli.build_parser().parse_args(
        ["orchestrator", "--verifier", "cpu"]).verifier == "cpu"


def test_orchestrator_cli_default_raises_without_a_card(tmp_path, monkeypatch):
    """``orchestrator`` on its default kind: the runner's verifier service
    cannot warm without a card, so the sweep raises before any node boots
    (and leaves no service behind) rather than verifying on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the default kind runs on the card where there is one")
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", _free_port_base(2))
    wd, results = tmp_path / "fleet", tmp_path / "results"
    with pytest.raises(RuntimeError, match="verifier service"):
        cli.main(["orchestrator", "--nodes", "2", "--duration", "1", "--working-directory",
                  str(wd), "--results-dir", str(results)])
    assert not list(wd.glob("node-*.log"))
    assert "Traceback" in (wd / "verifier-service.log").read_text()
    assert not (results / "measurements-0.json").exists()


def test_fleet_cli_static_lifecycle(tmp_path, capsys):
    """``fleet deploy / stop / status / destroy`` over a static pool, the
    state in a file between invocations, as the JAX CLI runs them."""
    state = str(tmp_path / "state.json")
    outs = []
    for pkg, module in (("mysticeti_tpu_torch", cli),
                        ("mysticeti_tpu", importlib.import_module("mysticeti_tpu.cli"))):
        path = f"{state}.{pkg}"
        # ``start`` waits for ssh on every host, so it is left out here.
        for action in ("deploy", "stop", "status", "destroy", "status"):
            assert module.main(["fleet", action, "--hosts", "u@h0", "u@h1", "--state",
                                path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "| i-0000 | u@h0 | local  | stopped |" in outs[0]
    assert "destroying 2 instance(s)" in outs[0]


def test_monitoring_stack_deploy(tmp_path):
    from mysticeti_tpu_torch.orchestrator.monitor import MonitoringStack

    stack = MonitoringStack(str(tmp_path / "monitor"))
    cfg = stack.deploy(["127.0.0.1:1504", "127.0.0.1:1505"])
    text = open(cfg).read()
    assert "127.0.0.1:1504" in text and "scrape_interval: 5s" in text
    dash = tmp_path / "monitor" / "grafana" / "dashboards" / "mysticeti.json"
    assert dash.exists()
    content = json.loads(dash.read_text())
    assert any("latency_s_count" in p["targets"][0]["expr"] for p in content["panels"])
    ds = tmp_path / "monitor" / "grafana" / "provisioning" / "datasources" / "prometheus.yaml"
    assert "prometheus" in ds.read_text()


def test_monitoring_config_equals_the_jax_packages():
    targets = ["10.0.0.1:2500", "10.0.0.2:2501"]
    got = [(_orch(pkg, "monitor").prometheus_config(targets, 7),
            _orch(pkg, "monitor").grafana_dashboard()) for pkg in PACKAGES]
    assert got[0] == got[1]


def _fake_binary(directory, name, marker):
    directory.mkdir(exist_ok=True)
    script = directory / name
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$GF_PATHS_PROVISIONING $*\" > {marker}\n"
        "exec sleep 60\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)


def test_monitoring_stack_spawns_grafana(tmp_path, monkeypatch):
    """start_grafana launches the binary against the generated provisioning
    tree (monitor.rs:86-104 parity), and stop() reaps it."""
    from mysticeti_tpu_torch.orchestrator.monitor import MonitoringStack

    marker = tmp_path / "grafana-started"
    _fake_binary(tmp_path / "bin", "grafana-server", marker)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")

    stack = MonitoringStack(str(tmp_path / "monitor"))
    stack.deploy(["127.0.0.1:1504"])
    assert stack.start_grafana()
    try:
        assert stack.grafana_proc is not None
        deadline = 50
        while not marker.exists() and deadline:
            time.sleep(0.1)
            deadline -= 1
        prov = marker.read_text().split()[0]
        assert prov.endswith("grafana/provisioning")
        # Dashboard provider path was rewritten from the container default to
        # the generated tree.
        provider_yaml = (
            tmp_path / "monitor" / "grafana" / "provisioning" / "dashboards"
            / "provider.yaml"
        ).read_text()
        assert "/etc/grafana/dashboards" not in provider_yaml
        assert str(tmp_path / "monitor" / "grafana" / "dashboards") in provider_yaml
    finally:
        stack.stop()
    assert stack.grafana_proc is None


def test_monitoring_stack_spawns_prometheus(tmp_path, monkeypatch):
    """start_prometheus launches the binary on the generated config."""
    from mysticeti_tpu_torch.orchestrator.monitor import PROMETHEUS_PORT, MonitoringStack

    marker = tmp_path / "prometheus-started"
    _fake_binary(tmp_path / "bin", "prometheus", marker)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    stack = MonitoringStack(str(tmp_path / "monitor"))
    stack.deploy(["127.0.0.1:1504"])
    assert stack.start_prometheus()
    try:
        deadline = 50
        while not marker.exists() and deadline:
            time.sleep(0.1)
            deadline -= 1
        args = marker.read_text()
        assert f"--config.file={tmp_path / 'monitor' / 'prometheus.yaml'}" in args
        assert f"--web.listen-address=127.0.0.1:{PROMETHEUS_PORT}" in args
    finally:
        stack.stop()
    assert stack.prometheus_proc is None


def test_monitoring_stack_grafana_absent(tmp_path, monkeypatch):
    from mysticeti_tpu_torch.orchestrator.monitor import MonitoringStack

    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    stack = MonitoringStack(str(tmp_path / "monitor"))
    stack.deploy(["127.0.0.1:1504"])
    assert stack.start_grafana() is False
    assert stack.start_prometheus() is False


def test_monitored_lock(tmp_path):
    from mysticeti_tpu_torch.utils.lock import MonitoredLock

    async def main():
        lock = MonitoredLock("test")
        async with lock:
            await asyncio.sleep(0.01)
        assert lock.hold_total_s >= 0.01

        # Contention is measured on the second waiter.
        async def holder():
            async with lock:
                await asyncio.sleep(0.02)

        task = asyncio.ensure_future(holder())
        await asyncio.sleep(0.001)
        async with lock:
            pass
        await task
        assert lock.wait_total_s >= 0.01

    asyncio.run(main())
