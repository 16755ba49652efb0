"""Testbed lifecycle: deploy / start / stop / destroy / status over a fleet.

The port's copy of ``mysticeti_tpu.orchestrator.testbed``.

Capability parity with ``orchestrator/src/testbed.rs`` (:21-210) and the
provider seam of ``orchestrator/src/client/mod.rs`` (`ServerProviderClient`
:68), re-targeted for this environment: the cloud SDK backends (aws.rs,
vultr.rs) are out of scope (no cloud credentials / egress), so providers
manage *inventory* — which hosts exist, whether they are active — while the
reference's install/update-over-ssh steps (orchestrator.rs:281-475) are
implemented against any reachable fleet via :class:`~.ssh.SshManager`.

Providers:

* :class:`StaticProvider` — a fixed host list (the operator's machines);
  deploy/destroy toggle inventory membership, start/stop toggle active state.
  State persists as JSON next to the settings so repeated CLI invocations
  see the same testbed (testbed.rs keeps this state in the cloud tags).
* Anything implementing :class:`ServerProvider` can back real provisioning.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .display import action, done, print_table, status
from .ssh import SshManager


@dataclass
class Instance:
    """client/mod.rs:18-60 `Instance` equivalent."""

    id: str
    host: str
    region: str = "local"
    active: bool = True

    def is_active(self) -> bool:
        return self.active


class ServerProvider:
    """client/mod.rs:68 `ServerProviderClient` seam."""

    async def list_instances(self) -> List[Instance]:
        raise NotImplementedError

    async def create_instances(self, count: int, region: str) -> List[Instance]:
        raise NotImplementedError

    async def start_instances(self, ids: Sequence[str]) -> None:
        raise NotImplementedError

    async def stop_instances(self, ids: Sequence[str]) -> None:
        raise NotImplementedError

    async def terminate_instances(self, ids: Sequence[str]) -> None:
        raise NotImplementedError


class StaticProvider(ServerProvider):
    """Inventory over a fixed pool of operator-supplied hosts.

    ``pool`` is every reachable host; "creating" an instance claims the next
    unclaimed pool entry, "terminating" releases it.  State is persisted to
    ``state_path`` as JSON.
    """

    def __init__(self, pool: Sequence[str], state_path: Optional[str] = None) -> None:
        self.pool = list(pool)
        self.state_path = state_path
        self._instances: Dict[str, Instance] = {}
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                for raw in json.load(f):
                    inst = Instance(**raw)
                    self._instances[inst.id] = inst
        # Monotonic id source: never reuse a live instance's id after a
        # terminate+create cycle (ids are `i-NNNN`; start past the highest
        # ever persisted).
        self._next_id = 1 + max(
            (int(i.id.rsplit("-", 1)[1]) for i in self._instances.values()),
            default=-1,
        )

    def _save(self) -> None:
        if self.state_path:
            with open(self.state_path, "w") as f:
                json.dump(
                    [dataclasses.asdict(i) for i in self._instances.values()],
                    f,
                    indent=2,
                )
                f.write("\n")

    async def list_instances(self) -> List[Instance]:
        return sorted(self._instances.values(), key=lambda i: i.id)

    async def create_instances(self, count: int, region: str) -> List[Instance]:
        claimed = {i.host for i in self._instances.values()}
        free = [h for h in self.pool if h not in claimed]
        if len(free) < count:
            raise RuntimeError(
                f"pool exhausted: need {count} hosts, {len(free)} free"
            )
        created = []
        for host in free[:count]:
            inst = Instance(id=f"i-{self._next_id:04d}", host=host,
                            region=region, active=True)
            self._next_id += 1
            self._instances[inst.id] = inst
            created.append(inst)
        self._save()
        return created

    async def start_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            self._instances[iid].active = True
        self._save()

    async def stop_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            self._instances[iid].active = False
        self._save()

    async def terminate_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            self._instances.pop(iid, None)
        self._save()


INSTALL_COMMANDS = (
    # orchestrator.rs:281 installs build deps + rust; a Python node only
    # needs the checkout and an interpreter, so install verifies those (the
    # kernels build with nvcc at their first use on the host).
    "python3 -c 'import sys; assert sys.version_info >= (3, 9)'",
)


class Testbed:
    """testbed.rs:21-210 equivalent: lifecycle operations over a provider."""

    __test__ = False  # not a pytest class, despite the name

    def __init__(
        self,
        provider: ServerProvider,
        ssh: Optional[SshManager] = None,
        repo_url: str = "",
        remote_repo: str = "mysticeti-tpu",
    ) -> None:
        self.provider = provider
        self.ssh = ssh
        self.repo_url = repo_url
        self.remote_repo = remote_repo

    async def deploy(self, count: int, region: str = "local") -> List[Instance]:
        action(f"deploying {count} instance(s) in {region}")
        created = await self.provider.create_instances(count, region)
        done(f"{len(created)} instance(s) deployed")
        return created

    async def start(self) -> None:
        insts = await self.provider.list_instances()
        action(f"starting {len(insts)} instance(s)")
        await self.provider.start_instances([i.id for i in insts])
        if self.ssh is not None:
            for inst in insts:
                await self.ssh.wait_reachable(inst.host)
        done()

    async def stop(self) -> None:
        insts = await self.provider.list_instances()
        action(f"stopping {len(insts)} instance(s)")
        await self.provider.stop_instances([i.id for i in insts])
        done()

    async def destroy(self) -> None:
        insts = await self.provider.list_instances()
        action(f"destroying {len(insts)} instance(s)")
        await self.provider.terminate_instances([i.id for i in insts])
        done()

    async def status(self) -> List[Instance]:
        insts = await self.provider.list_instances()
        print_table(
            ["id", "host", "region", "state"],
            [[i.id, i.host, i.region, "running" if i.active else "stopped"]
             for i in insts],
        )
        return insts

    # -- software lifecycle over ssh (orchestrator.rs:281-475) --

    def _require_ssh(self) -> SshManager:
        if self.ssh is None:
            raise RuntimeError("this operation needs an SshManager")
        return self.ssh

    async def active_hosts(self) -> List[str]:
        return [i.host for i in await self.provider.list_instances()
                if i.is_active()]

    async def install(self) -> None:
        """Verify/install prerequisites on every active instance."""
        ssh = self._require_ssh()
        hosts = await self.active_hosts()
        action(f"installing prerequisites on {len(hosts)} host(s)")
        for cmd in INSTALL_COMMANDS:
            await ssh.execute_all(cmd, hosts=hosts)
        done()

    async def update(self) -> None:
        """Clone or fast-forward the repo on every active instance
        (orchestrator.rs:399 `update`); no build step — the node is Python."""
        ssh = self._require_ssh()
        if not self.repo_url:
            raise RuntimeError("update requires a repo_url")
        hosts = await self.active_hosts()
        action(f"updating {self.remote_repo} on {len(hosts)} host(s)")
        cmd = (
            f"if [ -d {self.remote_repo}/.git ]; then"
            f" git -C {self.remote_repo} pull --ff-only;"
            f" else git clone {self.repo_url} {self.remote_repo}; fi"
        )
        await ssh.execute_all(cmd, hosts=hosts)
        done()

    async def download_logs(self, working_dir: str, dest_dir: str) -> List[str]:
        """Pull node logs from every active instance (orchestrator.rs log
        download step); returns the local paths."""
        ssh = self._require_ssh()
        hosts = await self.active_hosts()
        action(f"downloading logs from {len(hosts)} host(s)")
        paths = []
        for idx, host in enumerate(hosts):
            local = os.path.join(dest_dir, f"host-{idx}")
            await ssh.download(host, working_dir, local)
            paths.append(local)
            status(f"{host} -> {local}")
        done()
        return paths
