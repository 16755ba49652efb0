"""The port's fleet-management periphery: display, the ssh manager, the
testbed lifecycle, the ssh runner and the remote monitoring deploy.

Counterparts of ``tests/test_orchestrator_fleet.py``; the ssh tests inject a
fake transport at the ``_spawn`` seam instead of needing a live sshd, and
where the outcome is a wire conversation (argv lists) the port's is held to
the JAX package's, with the node command naming the port.  The reference's
profiling cases (``test_sampling_profiler_captures_busy_function``,
``test_flamegraph_svg_renders``) are held by ``test_torch_hostattr.py``
(``test_sampler_census_resolves_a_busy_port_thread``,
``test_flamegraph_svg_bytes_equal_the_jax_packages``,
``test_render_file_explicit_output_and_empty_profile``).
"""
import asyncio
import importlib
import io
import os

import pytest

from mysticeti_tpu_torch.orchestrator.display import format_table, progress, status
from mysticeti_tpu_torch.orchestrator.ssh import CommandContext, SshError, SshManager
from mysticeti_tpu_torch.orchestrator.testbed import StaticProvider, Testbed
from test_torch_cli import _free_port_base

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _orch(pkg, name):
    return importlib.import_module(f"{pkg}.orchestrator.{name}")


# ---------------------------------------------------------------------------
# display
# ---------------------------------------------------------------------------


def test_format_table_alignment():
    table = format_table(["id", "host"], [["i-0", "10.0.0.1"], ["i-11", "x"]])
    lines = table.splitlines()
    assert len({len(l) for l in lines}) == 1  # rectangular
    assert "i-11" in table and "10.0.0.1" in table


def test_status_and_progress_plain_streams():
    buf = io.StringIO()
    status("hello", stream=buf)
    progress(3, 10, "scrapes", stream=buf)
    out = buf.getvalue()
    assert "hello" in out and "3/10 scrapes" in out
    assert "\x1b[" not in out  # no ANSI on non-tty


def test_display_output_equals_the_jax_packages(monkeypatch):
    monkeypatch.delenv("NO_COLOR", raising=False)
    got = []
    for color in ("", "1"):
        if color:
            monkeypatch.setenv("FORCE_COLOR", color)
        for pkg in PACKAGES:
            display = _orch(pkg, "display")
            out, err = io.StringIO(), io.StringIO()
            display.action("deploying", out)
            display.status("step", out)
            display.done(stream=out)
            display.warn("careful", err)
            display.error("broken", err)
            for i in (0, 3, 10, 12):
                display.progress(i, 10, "runs", stream=out)
            display.print_table(["a", "bb"], [[1, "x"], ["long cell", 2.5]], stream=out)
            got.append((out.getvalue(), err.getvalue()))
    assert got[0] == got[1] and got[2] == got[3]
    assert "\x1b[" in got[2][0] and "\x1b[" not in got[0][0]


# ---------------------------------------------------------------------------
# ssh
# ---------------------------------------------------------------------------


def test_command_context_compose():
    ctx = CommandContext(path="/opt/repo", env={"TPS": "100"})
    assert ctx.apply("python3 -m mysticeti_tpu_torch run") == (
        "cd /opt/repo && TPS=100 python3 -m mysticeti_tpu_torch run"
    )


def test_command_context_background_pidfile():
    ctx = CommandContext(background="node-3", log_file="/tmp/n3.log")
    cmd = ctx.apply("sleep 60")
    assert "setsid nohup" in cmd
    assert "/tmp/.mysticeti-session-node-3.pid" in cmd
    assert "> /tmp/n3.log" in cmd
    # Spawn is guarded on a live pidfile so SshManager retries cannot
    # double-spawn the node after a dropped connection.
    assert cmd.startswith("if [ -f /tmp/.mysticeti-session-node-3.pid ]")
    assert "kill -0 -- -$(cat /tmp/.mysticeti-session-node-3.pid)" in cmd


@pytest.mark.parametrize("kwargs", [
    {}, {"path": "/opt/r x"}, {"env": {"TPS": "100", "A": "b c"}},
    {"background": "node-3", "log_file": "/tmp/n3.log"},
    {"path": "/p", "env": {"K": "$v"}, "background": "s"},
])
def test_command_context_equals_the_jax_packages(kwargs):
    got = [(_orch(pkg, "ssh").CommandContext(**kwargs).apply("python3 -c 'x'"),
            _orch(pkg, "ssh").CommandContext(**kwargs).pidfile()) for pkg in PACKAGES]
    assert got[0] == got[1]


class FlakyTransport(SshManager):
    """Fails the first N spawns, then succeeds; records every argv."""

    def __init__(self, hosts, fail_first=0, **kw):
        kw.setdefault("retry_delay_s", 0.0)
        super().__init__(hosts, **kw)
        self.fail_first = fail_first
        self.calls = []

    async def _spawn(self, argv, timeout_s):
        self.calls.append(argv)
        if len(self.calls) <= self.fail_first:
            return 255, b"connection refused"
        return 0, f"ok:{argv[-2]}".encode()


def test_ssh_retries_then_succeeds():
    mgr = FlakyTransport(["h0"], fail_first=2, retries=3)
    out = run(mgr.execute("h0", "true"))
    assert out.startswith("ok:")
    assert len(mgr.calls) == 3


def test_ssh_raises_after_final_retry():
    mgr = FlakyTransport(["h0"], fail_first=99, retries=2)
    with pytest.raises(SshError, match="exit 255"):
        run(mgr.execute("h0", "true"))
    assert len(mgr.calls) == 2


def test_ssh_parallel_fanout_all_hosts():
    hosts = [f"h{i}" for i in range(5)]
    mgr = FlakyTransport(hosts)
    outs = run(mgr.execute_all("uptime"))
    assert len(outs) == 5
    # every host saw the command
    assert {argv[-2] for argv in mgr.calls} == set(hosts)


def test_ssh_times_out_through_the_real_spawn():
    """The real ``_spawn`` (a local child, not ssh) returns the command's
    exit code and output, and kills a command past its deadline."""
    mgr = SshManager(["h0"], retries=1, retry_delay_s=0.0)
    assert run(mgr._spawn(["sh", "-c", "echo hi"], 10.0)) == (0, b"hi\n")
    with pytest.raises(asyncio.TimeoutError):
        run(mgr._spawn(["sleep", "5"], 0.2))


# ---------------------------------------------------------------------------
# testbed
# ---------------------------------------------------------------------------


def test_static_provider_lifecycle(tmp_path):
    state = str(tmp_path / "testbed.json")
    provider = StaticProvider(["10.0.0.1", "10.0.0.2", "10.0.0.3"], state)
    tb = Testbed(provider)

    created = run(tb.deploy(2, "local"))
    assert [i.host for i in created] == ["10.0.0.1", "10.0.0.2"]

    run(tb.stop())
    assert all(not i.active for i in run(provider.list_instances()))
    run(tb.start())
    assert all(i.active for i in run(provider.list_instances()))

    # state survives re-load (testbed.rs keeps this in cloud tags)
    provider2 = StaticProvider(["10.0.0.1", "10.0.0.2", "10.0.0.3"], state)
    assert [i.host for i in run(provider2.list_instances())] == [
        "10.0.0.1",
        "10.0.0.2",
    ]

    run(tb.destroy())
    assert run(provider.list_instances()) == []


def test_static_provider_state_file_equals_the_jax_packages(tmp_path, capsys):
    """The same lifecycle writes the same inventory file, and each package
    reads the other's."""
    texts = []
    for pkg in PACKAGES:
        testbed = _orch(pkg, "testbed")
        state = tmp_path / f"{pkg}.json"
        provider = testbed.StaticProvider(["h0", "h1", "h2", "h3"], str(state))
        tb = testbed.Testbed(provider)
        first = run(tb.deploy(3, "ewr"))
        run(provider.terminate_instances([first[1].id]))
        run(tb.deploy(1, "ams"))
        run(tb.stop())
        run(provider.start_instances([first[0].id]))
        run(tb.status())
        texts.append(state.read_text())
    assert texts[0] == texts[1]
    for pkg, other in zip(PACKAGES, reversed(PACKAGES)):
        loaded = _orch(pkg, "testbed").StaticProvider([], str(tmp_path / f"{other}.json"))
        assert [(i.id, i.host, i.region, i.active) for i in run(loaded.list_instances())] == [
            ("i-0000", "h0", "ewr", True), ("i-0002", "h2", "ewr", False),
            ("i-0003", "h1", "ams", False)]
    out = capsys.readouterr().out
    assert out.count("| i-0000 | h0   | ewr    | running |") == 2


def test_static_provider_ids_never_reused(tmp_path):
    """A terminate+create cycle must not hand a new instance a live
    instance's id (that would silently evict the live host from inventory)."""
    provider = StaticProvider(["h0", "h1", "h2"], str(tmp_path / "s.json"))
    first = run(provider.create_instances(2, "local"))
    run(provider.terminate_instances([first[0].id]))
    replacement = run(provider.create_instances(1, "local"))[0]
    live_ids = {i.id for i in run(provider.list_instances())}
    assert replacement.id not in {first[0].id, first[1].id}
    assert len(live_ids) == 2


def test_static_provider_pool_exhausted(tmp_path):
    provider = StaticProvider(["only-one"], str(tmp_path / "s.json"))
    with pytest.raises(RuntimeError, match="pool exhausted"):
        run(provider.create_instances(2, "local"))


def test_testbed_install_update_over_fake_ssh(tmp_path):
    provider = StaticProvider(["h0", "h1"], str(tmp_path / "s.json"))
    run(provider.create_instances(2, "local"))
    ssh = FlakyTransport(["h0", "h1"])
    tb = Testbed(provider, ssh=ssh, repo_url="https://example.com/repo.git")
    run(tb.install())
    run(tb.update())
    joined = [" ".join(argv) for argv in ssh.calls]
    assert any("git clone" in c or "git -C" in c for c in joined)
    assert {argv[-2] for argv in ssh.calls} == {"h0", "h1"}


class RecordingManager(SshManager):
    def __init__(self, hosts):
        super().__init__(hosts, retry_delay_s=0.0)
        self.commands = []  # argv lists

    async def _spawn(self, argv, timeout_s):
        self.commands.append(argv)
        return 0, b"ok"


def _ssh_runner_conversation(pkg):
    """Configure a 4-host ``SshRunner``, boot and kill node 2, clean up;
    returns the argv lists with the genesis temp dir masked."""
    runner_mod, ssh_mod = _orch(pkg, "runner"), _orch(pkg, "ssh")

    class Recording(ssh_mod.SshManager):
        def __init__(self, hosts):
            super().__init__(hosts, retry_delay_s=0.0)
            self.commands = []

        async def _spawn(self, argv, timeout_s):
            self.commands.append(argv)
            return 0, b"ok"

    hosts = ["u@h0", "u@h1", "u@h2", "u@h3"]
    mgr = Recording(hosts)
    runner = runner_mod.SshRunner(hosts, remote_repo="/opt/mysticeti", ssh=mgr,
                                  verifier="cpu")

    async def main():
        await runner.configure(4, load_tx_s=200)
        await runner.boot_node(2)
        await runner.kill_node(2)
        await runner.cleanup()

    asyncio.run(main())
    masked = []
    for argv in mgr.commands:
        masked.append([a if "mysticeti-genesis-" not in a else
                       a[:a.index("mysticeti-genesis-")] + "<genesis>"
                       + a[a.index("mysticeti-genesis-") + len("mysticeti-genesis-") + 8:]
                       for a in argv])
    return masked


def test_ssh_runner_composes_fleet_commands(tmp_path):
    """SshRunner rides SshManager: genesis upload, background boot under a
    pidfile session, kill-session teardown (orchestrator.rs:215-475 shape)."""
    from mysticeti_tpu_torch.orchestrator.runner import SshRunner

    hosts = ["u@h0", "u@h1", "u@h2", "u@h3"]
    mgr = RecordingManager(hosts)
    runner = SshRunner(hosts, remote_repo="/opt/mysticeti", ssh=mgr)
    assert runner.verifier == "cuda-only"  # the JAX runner's default: "tpu"

    async def main():
        await runner.configure(4, load_tx_s=200)
        await runner.boot_node(2)
        await runner.kill_node(2)
        await runner.cleanup()

    asyncio.run(main())
    flat = [" ".join(argv) for argv in mgr.commands]
    # upload happened per host (scp) after a mkdir
    assert sum("scp" == argv[0] for argv in mgr.commands) == 4
    assert any("mkdir -p" in c for c in flat)
    # boot: background session with pidfile, cd into the checkout, TPS env
    boot = [c for c in flat if "mysticeti_tpu_torch run" in c and "--authority 2" in c]
    assert boot and "setsid nohup" in boot[0] and "TPS=50" in boot[0]
    assert "mysticeti-node-2.pid" in boot[0]
    assert "cd /opt/mysticeti" in boot[0]
    assert "--verifier cuda-only" in boot[0]
    assert not any("-m mysticeti_tpu " in c for c in flat)
    # teardown kills the session pidfile for every node
    kills = [c for c in flat if ".pid" in c and "kill" in c]
    assert len(kills) >= 5  # node 2 once + cleanup x4


def test_ssh_runner_conversation_equals_the_jax_packages():
    """Argv for argv the JAX runner's, but for the module the node runs."""
    port = _ssh_runner_conversation("mysticeti_tpu_torch")
    jax = _ssh_runner_conversation("mysticeti_tpu")
    assert len(port) == len(jax) == 4 * 3 + 1 + 1 + 4  # rm, mkdir, scp a host
    renamed = [[a.replace("-m mysticeti_tpu run", "-m mysticeti_tpu_torch run") for a in argv]
               for argv in jax]
    assert port == renamed != jax


def test_settings_make_ssh_runner_and_testbed_logs(tmp_path):
    """Settings -> SshRunner construction and Testbed.download_logs over the
    fake transport (the `fleet logs` CLI path)."""
    from mysticeti_tpu_torch.orchestrator.runner import SshRunner
    from mysticeti_tpu_torch.orchestrator.settings import Settings

    s = Settings(runner="ssh", hosts=["u@h0", "u@h1"], remote_repo="/opt/m")
    runner = s.make_runner()
    assert isinstance(runner, SshRunner) and runner.remote_repo == "/opt/m"
    assert runner.verifier == "cuda-only"

    provider = StaticProvider(["u@h0", "u@h1"], str(tmp_path / "s.json"))
    run(provider.create_instances(2, "local"))
    ssh = FlakyTransport(["u@h0", "u@h1"])
    tb = Testbed(provider, ssh=ssh)
    dest = str(tmp_path / "logs")
    paths = run(tb.download_logs("/tmp/mysticeti-bench", dest))
    assert len(paths) == 2
    scps = [argv for argv in ssh.calls if argv[0] == "scp"]
    assert len(scps) == 2
    assert any("u@h0:/tmp/mysticeti-bench" in " ".join(a) for a in scps)


def _remote_monitoring(pkg, out_dir):
    monitor, ssh_mod = _orch(pkg, "monitor"), _orch(pkg, "ssh")

    class RecordingSsh(ssh_mod.SshManager):
        def __init__(self):
            super().__init__(["monitor@10.0.0.9"], retries=1)
            self.commands = []

        async def _spawn(self, argv, timeout_s):
            self.commands.append(argv)
            return 0, b""

    ssh = RecordingSsh()
    stack = monitor.MonitoringStack(out_dir)
    url = run(stack.deploy_remote(ssh, "monitor@10.0.0.9", ["10.0.0.1:1500", "10.0.0.2:1500"]))
    before = len(ssh.commands)
    run(stack.stop_remote(ssh, "monitor@10.0.0.9"))
    return url, [[a.replace(out_dir, "<out>") for a in argv] for argv in ssh.commands], before


def test_monitoring_stack_remote_deploy(tmp_path):
    """monitor.rs:60-105 parity: the stack deploys onto a dedicated
    monitoring instance over the ssh manager — config tree uploaded,
    prometheus + grafana (re)started as background sessions."""
    from mysticeti_tpu_torch.orchestrator.monitor import GRAFANA_PORT

    url, commands, before = _remote_monitoring("mysticeti_tpu_torch", str(tmp_path / "mon"))
    assert url == f"http://10.0.0.9:{GRAFANA_PORT}"
    # The generated tree exists locally and was scp'd to the instance.
    assert (tmp_path / "mon" / "prometheus.yaml").exists()
    flat = ["\x00".join(argv) for argv in commands]
    assert any(a.startswith("scp") and "prometheus.yaml" in a for a in flat)
    joined = " ".join(flat)
    assert "prometheus --config.file=" in joined
    assert "grafana server" in joined
    # Both services run as background sessions (kill_session-compatible).
    assert "mysticeti-prometheus" in joined
    assert "mysticeti-grafana" in joined
    # Teardown kills both sessions.
    assert len(commands) == before + 2


def test_monitoring_remote_conversation_and_tree_equal_the_jax_packages(tmp_path):
    got = [_remote_monitoring(pkg, str(tmp_path / pkg)) for pkg in PACKAGES]
    assert got[0] == got[1]
    trees = []
    for pkg in PACKAGES:
        root = tmp_path / pkg
        trees.append({p.relative_to(root).as_posix(): p.read_text()
                      for p in sorted(root.rglob("*")) if p.is_file()})
    assert trees[0] == trees[1] and len(trees[0]) == 4


def _local_runner_commands(pkg, tmp_path, kind, monkeypatch, relative=False):
    """The argv, environment and working directory of every child a
    package's ``LocalProcessRunner`` starts for a 3-node run of ``kind``
    in ``tmp_path / pkg`` (named relative to the current directory when
    ``relative``; the children faked, the service's warm-up skipped)."""
    runner_mod = _orch(pkg, "runner")
    config = importlib.import_module(f"{pkg}.config")
    monkeypatch.setattr(config, "DEFAULT_PORT_BASE", _free_port_base(3))
    spawned = []

    class Child:
        returncode = None
        pid = 4242

        def send_signal(self, sig):
            self.returncode = -sig

        async def wait(self):
            return self.returncode

    async def fake_exec(*argv, env=None, stdout=None, stderr=None, cwd=None):
        spawned.append((argv, {k: env.get(k) for k in ("TPS", "TRANSACTION_SIZE",
                                                       "MYSTICETI_VERIFIER_SOCKET")}, cwd))
        return Child()

    async def warm(self):
        return None

    monkeypatch.setattr(runner_mod.asyncio, "create_subprocess_exec", fake_exec)
    monkeypatch.setattr(runner_mod.LocalProcessRunner, "_await_service_warm", warm)
    wd = tmp_path / pkg
    runner = runner_mod.LocalProcessRunner(os.path.relpath(wd) if relative else str(wd),
                                           verifier=kind)

    async def main():
        await runner.configure(3, load_tx_s=300)
        for a in range(3):
            await runner.boot_node(a)
        await runner.cleanup()

    asyncio.run(main())
    monkeypatch.undo()
    return [([a.replace(str(wd), "<wd>") for a in argv[1:]],
             {k: v and v.replace(str(wd), "<wd>") for k, v in env.items()}, cwd)
            for argv, env, cwd in spawned]


@pytest.mark.parametrize("kinds", [("cuda-only", "tpu-only"), ("cuda", "tpu"),
                                   ("cuda-agg", "tpu-agg"), ("cpu", "cpu")])
def test_local_runner_starts_the_ports_node_and_service(tmp_path, monkeypatch, kinds):
    """A card kind gets one verifier service before the nodes, which reach
    it through ``MYSTICETI_VERIFIER_SOCKET``; the children run the port's
    module from the repository root, argv for argv the JAX runner's for the
    matching kind."""
    port = _local_runner_commands("mysticeti_tpu_torch", tmp_path, kinds[0], monkeypatch)
    jax = _local_runner_commands("mysticeti_tpu", tmp_path, kinds[1], monkeypatch)
    card = kinds[0] != "cpu"
    assert len(port) == len(jax) == 3 + card
    renamed = [([{"mysticeti_tpu": "mysticeti_tpu_torch", kinds[1]: kinds[0]}.get(a, a)
                 for a in argv], env, cwd) for argv, env, cwd in jax]
    assert port == renamed
    assert all(argv[:2] == ["-m", "mysticeti_tpu_torch"] for argv, _, _ in port)
    assert {cwd for _, _, cwd in port} == {os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))}
    socket = port[0][0][port[0][0].index("--socket") + 1] if card else None
    if card:
        assert port[0][0][2] == "verifier-service" and socket == "<wd>/verifier.sock"
    for argv, env, _ in port[card:]:
        assert argv[2] == "run" and argv[-1] == kinds[0]
        assert env["TPS"] == "100" and env["TRANSACTION_SIZE"] == "512"
        assert env["MYSTICETI_VERIFIER_SOCKET"] == socket


def test_local_runner_defaults_to_the_card_and_refuses_busy_ports(tmp_path, monkeypatch):
    import socket

    from mysticeti_tpu_torch import config as port_config
    from mysticeti_tpu_torch.orchestrator.runner import LocalProcessRunner

    assert LocalProcessRunner(str(tmp_path)).verifier == "cuda-only"  # the JAX runner's: "cpu"
    base = _free_port_base(2)
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", base)
    with socket.socket() as held:
        held.bind(("127.0.0.1", base + 1001))
        held.listen()
        runner = LocalProcessRunner(str(tmp_path / "fleet"), verifier="cpu")
        with pytest.raises(RuntimeError, match=f"ports already in use.*{base + 1001}"):
            asyncio.run(runner.configure(2))


def test_local_runner_resolves_a_relative_working_dir(tmp_path, monkeypatch):
    """The nodes run from the repository root, so the runner hands them
    absolute paths whatever directory the sweep was started from."""
    monkeypatch.chdir(tmp_path)
    commands = _local_runner_commands("mysticeti_tpu_torch", tmp_path, "cpu", monkeypatch,
                                      relative=True)
    assert (tmp_path / "mysticeti_tpu_torch" / "committee.yaml").exists()
    for argv, _env, _cwd in commands:
        paths = [a for a in argv if a.endswith(".yaml") or "validator-" in a]
        assert paths and all(a.startswith("<wd>/") for a in paths)
