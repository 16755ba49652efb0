"""SSH connection manager: retried, timed-out, parallel remote execution.

The port's copy of ``mysticeti_tpu.orchestrator.ssh``.

Capability parity with ``orchestrator/src/ssh.rs``:

* ``CommandContext`` (ssh.rs:83) — working dir, env prefix, background
  session wrapping.  The reference runs background work under
  ``tmux new -d -s <id>``; here background commands run under
  ``setsid nohup`` with a pidfile per session name, which needs nothing
  installed on the target.
* ``SshManager`` (ssh.rs:99-272) — per-host retried execute with timeout,
  parallel fan-out over many hosts, upload/download (scp), reachability wait.

The process-spawn seam (``_spawn``) is the unit-test boundary: tests inject a
fake transport instead of needing a live sshd.
"""
from __future__ import annotations

import asyncio
import os
import shlex
from typing import Dict, List, Optional, Sequence, Tuple


class SshError(Exception):
    pass


class CommandContext:
    """How to run a remote command (ssh.rs:83 `CommandContext::apply`)."""

    def __init__(
        self,
        path: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        background: Optional[str] = None,
        log_file: Optional[str] = None,
    ) -> None:
        self.path = path
        self.env = env or {}
        self.background = background
        self.log_file = log_file

    def pidfile(self) -> Optional[str]:
        if self.background is None:
            return None
        return f"/tmp/.mysticeti-session-{self.background}.pid"

    def apply(self, command: str) -> str:
        parts = []
        if self.path:
            parts.append(f"cd {shlex.quote(self.path)} &&")
        for key, value in self.env.items():
            parts.append(f"{key}={shlex.quote(value)}")
        if self.background is not None:
            log = self.log_file or "/dev/null"
            # The marker comment rides in the spawned shell's cmdline so the
            # liveness probe below can tell OUR session apart from an
            # unrelated process that recycled the pid after a crash.  The
            # trailing marker no-op keeps the shell RESIDENT: with it, the
            # command is not the tail of `sh -c`, so bash cannot exec-replace
            # the shell (which would swap the cmdline out for the command's
            # own argv and lose the marker on sh->bash hosts).
            marker = f"mysticeti-session-{self.background}"
            inner = (
                f": {marker}; " + " ".join(parts + [command]) + f"; : {marker}"
            )
            pidfile = self.pidfile()
            # Idempotent spawn: SshManager.execute retries on transient
            # failures, and a dropped connection after the remote process
            # launched would otherwise double-spawn it (and the pidfile would
            # only remember the last pid, orphaning the first).  Guard on a
            # live pidfile the way the reference's `tmux new -s <id>` fails
            # fast on a duplicate session name (ssh.rs:83).  Liveness =
            # process group alive AND the pid's cmdline carries our session
            # marker: `kill -0` alone would trust any recycled pid and
            # silently skip the respawn of a crashed node.
            spawn = (
                f"setsid nohup sh -c {shlex.quote(inner)} > {log} 2>&1 &"
                f" echo $! > {pidfile}"
            )
            return (
                f"if [ -f {pidfile} ] && kill -0 -- -$(cat {pidfile})"
                f" 2>/dev/null && grep -aq -- {shlex.quote(marker)}"
                f" /proc/$(cat {pidfile})/cmdline 2>/dev/null;"
                f" then true; else {spawn}; fi"
            )
        return " ".join(parts + [command])


class SshManager:
    """Retried/parallel command execution over the system ssh/scp binaries.

    ``hosts`` may be ``user@addr`` or bare addresses.  All operations accept
    an optional per-call timeout and retry transient failures with a linear
    backoff (ssh.rs retries :198-236).
    """

    def __init__(
        self,
        hosts: Sequence[str],
        ssh_args: Optional[List[str]] = None,
        retries: int = 3,
        timeout_s: float = 30.0,
        retry_delay_s: float = 2.0,
    ) -> None:
        self.hosts = list(hosts)
        self.ssh_args = list(
            ssh_args
            if ssh_args is not None
            else ["-o", "StrictHostKeyChecking=no", "-o", "ConnectTimeout=10"]
        )
        self.retries = retries
        self.timeout_s = timeout_s
        self.retry_delay_s = retry_delay_s

    # -- transport seam (overridden by tests) --

    async def _spawn(self, argv: List[str], timeout_s: float) -> Tuple[int, bytes]:
        proc = await asyncio.create_subprocess_exec(
            *argv,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            stdin=asyncio.subprocess.DEVNULL,
        )
        try:
            out, _ = await asyncio.wait_for(proc.communicate(), timeout=timeout_s)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            raise
        return proc.returncode or 0, out

    # -- single-host operations --

    async def execute(
        self,
        host: str,
        command: str,
        context: Optional[CommandContext] = None,
        timeout_s: Optional[float] = None,
    ) -> str:
        """Run a command, retrying transient failures; returns stdout+stderr.

        Raises :class:`SshError` after the final retry (non-zero exit or
        timeout).
        """
        full = (context or CommandContext()).apply(command)
        argv = ["ssh", *self.ssh_args, host, full]
        deadline = timeout_s if timeout_s is not None else self.timeout_s
        last: Optional[str] = None
        for attempt in range(self.retries):
            try:
                rc, out = await self._spawn(argv, deadline)
            except asyncio.TimeoutError:
                last = f"timeout after {deadline}s"
            else:
                if rc == 0:
                    return out.decode(errors="replace")
                last = f"exit {rc}: {out.decode(errors='replace')[-500:]}"
            if attempt + 1 < self.retries:
                await asyncio.sleep(self.retry_delay_s * (attempt + 1))
        raise SshError(f"ssh {host}: {command!r} failed ({last})")

    async def upload(
        self, host: str, local_paths: Sequence[str], remote_dir: str
    ) -> None:
        await self.execute(host, f"mkdir -p {shlex.quote(remote_dir)}")
        argv = ["scp", *self.ssh_args, "-r", *local_paths, f"{host}:{remote_dir}/"]
        await self._retried_copy(argv, f"upload to {host}")

    async def download(self, host: str, remote_path: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        argv = ["scp", *self.ssh_args, "-r", f"{host}:{remote_path}", local_path]
        await self._retried_copy(argv, f"download from {host}")

    async def _retried_copy(self, argv: List[str], what: str) -> None:
        last: Optional[str] = None
        for attempt in range(self.retries):
            try:
                rc, out = await self._spawn(argv, self.timeout_s)
            except asyncio.TimeoutError:
                last = "timeout"
            else:
                if rc == 0:
                    return
                last = out.decode(errors="replace")[-500:]
            if attempt + 1 < self.retries:
                await asyncio.sleep(self.retry_delay_s * (attempt + 1))
        raise SshError(f"{what} failed ({last})")

    async def kill_session(self, host: str, session: str) -> None:
        """Kill a background session started with CommandContext(background=)."""
        pidfile = CommandContext(background=session).pidfile()
        await self.execute(
            host,
            f"[ -f {pidfile} ] && kill -- -$(cat {pidfile}) 2>/dev/null;"
            f" rm -f {pidfile}; true",
        )

    async def wait_reachable(self, host: str, timeout_s: float = 300.0) -> None:
        """Poll until the host accepts ssh (ssh.rs `wait_until_reachable`)."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout_s
        while True:
            try:
                await self.execute(host, "true", timeout_s=10.0)
                return
            except SshError:
                if loop.time() >= deadline:
                    raise
                await asyncio.sleep(5.0)

    # -- fleet fan-out --

    async def execute_all(
        self,
        command: str,
        context: Optional[CommandContext] = None,
        hosts: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """Run the same command on every host in parallel; raises the first
        failure after all hosts finish (ssh.rs `execute` over instances)."""
        targets = list(hosts if hosts is not None else self.hosts)
        results = await asyncio.gather(
            *(self.execute(h, command, context) for h in targets),
            return_exceptions=True,
        )
        for res in results:
            if isinstance(res, BaseException):
                raise res
        return [r for r in results if isinstance(r, str)]

    async def execute_per_host(
        self,
        commands: Sequence[Tuple[str, str]],
        context: Optional[CommandContext] = None,
    ) -> List[str]:
        """Run a distinct command per (host, command) pair in parallel."""
        results = await asyncio.gather(
            *(self.execute(h, c, context) for h, c in commands),
            return_exceptions=True,
        )
        for res in results:
            if isinstance(res, BaseException):
                raise res
        return [r for r in results if isinstance(r, str)]
