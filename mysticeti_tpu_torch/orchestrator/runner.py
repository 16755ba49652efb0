"""Deployment runners: local multiprocess fleet and ssh-CLI remote fleet.

The port's copy of ``mysticeti_tpu.orchestrator.runner``.

Capability parity with ``orchestrator/src/orchestrator.rs`` (boot_nodes :215,
run_nodes :476, kill/cleanup) + ``ssh.rs`` — re-targeted: the reference shells
into cloud instances over libssh2 and runs binaries under tmux; here the
``Runner`` seam abstracts "start validator i / kill validator i / scrape i":

* ``LocalProcessRunner`` — subprocess per validator on localhost (the dry-run
  scale, fully tested in CI);
* ``SshRunner`` — same operations through the system ``ssh`` binary with
  ``nohup`` (no cloud SDK / libssh dependency; provisioning is out of scope —
  point it at any fleet of reachable hosts).

Both run the port's node, ``python -m mysticeti_tpu_torch run``, and default
to the ``cuda-only`` kind (``cli.DEFAULT_VERIFIER``; the JAX runners'
defaults are ``cpu`` and ``tpu``): without a card a fleet fails rather than
verifying on the CPU.  A ``cuda*`` kind (``cuda``, ``cuda-only``,
``cuda-agg``) on the local runner gets one warmed verifier service on the
card for the whole fleet, which its nodes reach through
``MYSTICETI_VERIFIER_SOCKET``; ``MYSTICETI_NO_VERIFIER_SERVICE`` gives every
node a card context of its own instead.
"""
from __future__ import annotations

import asyncio
import os
import signal
import sys
from typing import Dict, List, Optional

from ..cli import DEFAULT_VERIFIER, benchmark_genesis
from ..config import Parameters


# The node kinds that verify on the card (``cuda``, ``cuda-only``,
# ``cuda-agg``): a local fleet of one of them shares one verifier service.
CARD_KIND_PREFIX = "cuda"
# How long ``cleanup`` waits for the verifier service to end on SIGTERM.
SERVICE_STOP_S = 10.0


class Runner:
    async def configure(self, committee_size: int, load_tx_s: int = 0) -> None:
        raise NotImplementedError

    async def boot_node(self, authority: int) -> None:
        raise NotImplementedError

    async def kill_node(self, authority: int) -> None:
        raise NotImplementedError

    async def scrape(self, authority: int) -> Optional[str]:
        """Fetch the node's /metrics text, or None when unreachable."""
        raise NotImplementedError

    async def host_sample(self) -> Optional[dict]:
        """One host-metrics sample covering the fleet (node_exporter
        equivalent — hostmon.py); None when the runner cannot observe its
        hosts."""
        return None

    async def cleanup(self) -> None:
        raise NotImplementedError


async def _http_get_metrics(host: str, port: int, timeout: float = 5.0,
                            path: str = "/metrics") -> Optional[str]:
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout=timeout
        )
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(-1), timeout=timeout)
        writer.close()
        body = data.split(b"\r\n\r\n", 1)
        return body[1].decode() if len(body) == 2 else None
    except (OSError, asyncio.TimeoutError):
        return None


# One orchestration coroutine drives start/run/stop sequentially; the
# lifecycle fields never see a concurrent writer, so read-await-write
# spans in these methods cannot interleave.
# lint: single-owner[orchestrator]
class LocalProcessRunner(Runner):
    def __init__(
        self,
        working_dir: str,
        tps_per_node: int = 100,
        transaction_size: int = 512,
        verifier: str = DEFAULT_VERIFIER,
    ) -> None:
        # Absolute: the nodes and the service run from the repository root,
        # not from the caller's directory (the JAX runner keeps the path as
        # given, so a relative one breaks its nodes started elsewhere).
        self.working_dir = os.path.abspath(working_dir)
        self.tps_per_node = tps_per_node
        self.transaction_size = transaction_size
        self.verifier = verifier
        self.committee_size = 0
        self.processes: Dict[int, asyncio.subprocess.Process] = {}
        self.parameters: Optional[Parameters] = None
        self._host_sampler = None
        self._verifier_service: Optional[asyncio.subprocess.Process] = None
        self._service_socket: Optional[str] = None

    async def configure(self, committee_size: int, load_tx_s: int = 0) -> None:
        self.committee_size = committee_size
        if load_tx_s > 0:
            # The sweep's offered load for THIS run, split across the committee
            # (protocol/mysticeti.rs:116 passes TPS the same way).
            self.tps_per_node = max(1, load_tx_s // committee_size)
        # Wipe per-validator state from any previous run (orchestrator.rs
        # cleanup step): genesis regenerates keys, so a stale WAL replayed
        # into the fresh committee fails verification wholesale — every block
        # suspends and the run drowns in sync traffic instead of committing.
        import glob
        import shutil

        for path in glob.glob(os.path.join(self.working_dir, "validator-*")):
            shutil.rmtree(path, ignore_errors=True)
        benchmark_genesis(["127.0.0.1"] * committee_size, self.working_dir)
        self.parameters = Parameters.load(
            os.path.join(self.working_dir, "parameters.yaml")
        )
        self._assert_ports_free()
        if (
            self.verifier.startswith(CARD_KIND_PREFIX)
            and not os.environ.get("MYSTICETI_NO_VERIFIER_SERVICE")
        ):
            await self._start_verifier_service()

    async def _start_verifier_service(self) -> None:
        """One warmed card runtime for the whole fleet
        (verifier_service.py): started before the nodes so its kernel load
        and key-table upload overlap their boot; nodes find it via
        MYSTICETI_VERIFIER_SOCKET and never open a CUDA context of their
        own."""
        if self._verifier_service is not None:
            return
        self._service_socket = os.path.join(
            os.path.abspath(self.working_dir), "verifier.sock"
        )
        # A previous run's cleanup kills the service, skipping its own
        # unlink — a stale socket file would satisfy the exists() wait below
        # before the fresh process has bound it.
        if os.path.exists(self._service_socket):
            os.unlink(self._service_socket)
        log = open(os.path.join(self.working_dir, "verifier-service.log"), "ab")
        env = dict(os.environ)
        env.pop("MYSTICETI_VERIFIER_SOCKET", None)  # the service IS the backend
        self._verifier_service = await asyncio.create_subprocess_exec(
            sys.executable,
            "-m",
            "mysticeti_tpu_torch",
            "verifier-service",
            "--socket",
            self._service_socket,
            "--committee-path",
            os.path.join(self.working_dir, "committee.yaml"),
            env=env,
            stdout=log,
            stderr=log,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        )
        try:
            await self._await_service_warm()
        except BaseException:
            # A failed boot must not leak the child: an orphaned service
            # would hold the card and contend with the next run's service
            # for it.
            service, self._verifier_service = self._verifier_service, None
            self._service_socket = None
            if service is not None and service.returncode is None:
                service.send_signal(signal.SIGKILL)
                await service.wait()
            raise

    async def _await_service_warm(self) -> None:
        # The socket appears as soon as the listener is up.
        for _ in range(600):
            if os.path.exists(self._service_socket):
                break
            if self._verifier_service.returncode is not None:
                raise RuntimeError(
                    "verifier service died at boot — see verifier-service.log"
                )
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError("verifier service socket never appeared")
        # Block until the service is WARM (HELLO round-trip), not merely
        # listening: booting validators early makes them contend for the
        # host's cores exactly while the service is paying its one-time
        # kernel load and warm-up — on a small host that contention can starve the
        # warmup for the whole measurement window.  A host daemon being warm
        # before validators start is also the deployment shape.
        from ..committee import Committee
        from ..verifier_service import RemoteSignatureVerifier

        committee = Committee.load(
            os.path.join(self.working_dir, "committee.yaml")
        )
        probe = RemoteSignatureVerifier(
            socket_path=self._service_socket,
            committee_keys=committee.public_key_bytes(),
            timeout_s=900.0,
        )
        loop = asyncio.get_running_loop()
        for _ in range(50):
            try:
                await loop.run_in_executor(None, probe.warmup)
                return
            except (ConnectionError, OSError):
                # Bound but briefly unready, or unlink/bind race: retry
                # while the subprocess is alive.
                if self._verifier_service.returncode is not None:
                    raise RuntimeError(
                        "verifier service died during warmup — see "
                        "verifier-service.log"
                    )
                await asyncio.sleep(0.2)
        raise RuntimeError("verifier service never became warm")

    def _assert_ports_free(self) -> None:
        """Fail fast when another fleet holds our ports: a node that cannot
        bind crashes AFTER genesis, and the scraper would then silently read
        metrics from the stale process that owns the port — poisoning every
        measurement with another run's counters."""
        import socket

        busy = []
        for authority in range(self.committee_size):
            for _, port in (
                self.parameters.address(authority),
                self.parameters.metrics_address(authority),
            ):
                with socket.socket() as s:
                    # REUSEADDR matches the servers' bind semantics: sockets
                    # in TIME_WAIT from the previous fleet are fine, only a
                    # live listener must fail the check.
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    try:
                        s.bind(("127.0.0.1", port))
                    except OSError:
                        busy.append(port)
        if busy:
            raise RuntimeError(
                f"ports already in use (stale fleet?): {sorted(set(busy))}"
            )

    async def boot_node(self, authority: int) -> None:
        env = dict(os.environ)
        env["TPS"] = str(self.tps_per_node)
        env["TRANSACTION_SIZE"] = str(self.transaction_size)
        env.setdefault("INITIAL_DELAY", "1")
        if self._service_socket is not None:
            env["MYSTICETI_VERIFIER_SOCKET"] = self._service_socket
        log = open(os.path.join(self.working_dir, f"node-{authority}.log"), "ab")
        proc = await asyncio.create_subprocess_exec(
            sys.executable,
            "-m",
            "mysticeti_tpu_torch",
            "run",
            "--authority",
            str(authority),
            "--committee-path",
            os.path.join(self.working_dir, "committee.yaml"),
            "--parameters-path",
            os.path.join(self.working_dir, "parameters.yaml"),
            "--private-config-path",
            os.path.join(self.working_dir, f"validator-{authority}"),
            "--verifier",
            self.verifier,
            env=env,
            stdout=log,
            stderr=log,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        )
        self.processes[authority] = proc

    async def kill_node(self, authority: int) -> None:
        proc = self.processes.pop(authority, None)
        if proc is not None and proc.returncode is None:
            proc.send_signal(signal.SIGKILL)
            await proc.wait()

    async def scrape(self, authority: int) -> Optional[str]:
        host, port = self.parameters.metrics_address(authority)
        return await _http_get_metrics("127.0.0.1", port)

    async def host_sample(self) -> Optional[dict]:
        if self._host_sampler is None:
            try:
                from .hostmon import HostSampler

                self._host_sampler = HostSampler()
            except ImportError:  # no psutil on this host: no host series
                return None
        pids = {
            f"node-{a}": proc.pid
            for a, proc in self.processes.items()
            if proc.returncode is None
        }
        return self._host_sampler.sample(pids)

    async def cleanup(self) -> None:
        for authority in list(self.processes):
            await self.kill_node(authority)
        service, self._verifier_service = self._verifier_service, None
        if service is not None and service.returncode is None:
            # SIGTERM first: it ends a service that does not handle it at
            # once, as SIGKILL would, and gives one that does (a launch
            # reporter, say) a moment to finish before the SIGKILL.
            service.send_signal(signal.SIGTERM)
            try:
                await asyncio.wait_for(service.wait(), SERVICE_STOP_S)
            except asyncio.TimeoutError:
                service.send_signal(signal.SIGKILL)
                await service.wait()


class SshRunner(Runner):
    """Remote fleet over :class:`~.ssh.SshManager` (ssh.rs re-imagined):
    retried/timed-out remote execution, scp config upload, background node
    sessions with pidfiles.

    ``hosts``: one reachable address per validator.  Assumes the repo is
    deployed at ``remote_repo`` on every host (``fleet install``/``update``
    handle that, or a one-line ``git clone`` per host).
    """

    def __init__(
        self,
        hosts: List[str],
        remote_repo: str,
        working_dir: str = "/tmp/mysticeti-bench",
        python: str = "python3",
        tps_per_node: int = 100,
        verifier: str = DEFAULT_VERIFIER,
        ssh_args: Optional[List[str]] = None,
        ssh: Optional["SshManager"] = None,
    ) -> None:
        from .ssh import SshManager

        self.hosts = hosts
        self.remote_repo = remote_repo
        self.working_dir = working_dir
        self.python = python
        self.tps_per_node = tps_per_node
        self.verifier = verifier
        self.ssh = ssh or SshManager(hosts, ssh_args=ssh_args)
        self.parameters: Optional[Parameters] = None

    def _session(self, authority: int) -> str:
        return f"mysticeti-node-{authority}"

    async def configure(self, committee_size: int, load_tx_s: int = 0) -> None:
        assert committee_size <= len(self.hosts)
        if load_tx_s > 0:
            self.tps_per_node = max(1, load_tx_s // committee_size)
        import tempfile

        local = tempfile.mkdtemp(prefix="mysticeti-genesis-")
        benchmark_genesis(self.hosts[:committee_size], local)
        self.parameters = Parameters.load(os.path.join(local, "parameters.yaml"))
        for i, host in enumerate(self.hosts[:committee_size]):
            await self.ssh.execute(host, f"rm -rf {self.working_dir}/validator-{i}")
            await self.ssh.upload(
                host,
                [
                    os.path.join(local, "committee.yaml"),
                    os.path.join(local, "parameters.yaml"),
                    os.path.join(local, f"validator-{i}"),
                ],
                self.working_dir,
            )

    async def boot_node(self, authority: int) -> None:
        from .ssh import CommandContext

        host = self.hosts[authority]
        context = CommandContext(
            path=self.remote_repo,
            env={"TPS": str(self.tps_per_node)},
            background=self._session(authority),
            log_file=f"{self.working_dir}/node-{authority}.log",
        )
        await self.ssh.execute(
            host,
            f"{self.python} -m mysticeti_tpu_torch run --authority {authority}"
            f" --committee-path {self.working_dir}/committee.yaml"
            f" --parameters-path {self.working_dir}/parameters.yaml"
            f" --private-config-path {self.working_dir}/validator-{authority}"
            f" --verifier {self.verifier}",
            context,
        )

    async def kill_node(self, authority: int) -> None:
        await self.ssh.kill_session(self.hosts[authority], self._session(authority))

    async def scrape(self, authority: int) -> Optional[str]:
        host, port = self.parameters.metrics_address(authority)
        return await _http_get_metrics(self.hosts[authority].split("@")[-1], port)

    async def host_sample(self) -> Optional[dict]:
        from .hostmon import REMOTE_SAMPLE_CMD, parse_remote_sample
        from .ssh import SshError

        hosts = {}
        for i, host in enumerate(self.hosts):
            try:
                out = await self.ssh.execute(host, REMOTE_SAMPLE_CMD)
            except SshError:
                continue
            parsed = parse_remote_sample(out)
            if parsed is not None:
                hosts[f"host-{i}"] = parsed
        if not hosts:
            return None
        import time as _time

        return {"timestamp_s": _time.time(), "hosts": hosts}

    async def download_logs(self, dest_dir: str) -> List[str]:
        """Pull every node's log (orchestrator.rs log-download step)."""
        paths = []
        for i, host in enumerate(self.hosts):
            local = os.path.join(dest_dir, f"node-{i}.log")
            await self.ssh.download(
                host, f"{self.working_dir}/node-{i}.log", local
            )
            paths.append(local)
        return paths

    async def cleanup(self) -> None:
        for i in range(len(self.hosts)):
            await self.kill_node(i)
