"""Benchmark settings model: the orchestrator's persisted configuration.

The port's copy of ``mysticeti_tpu.orchestrator.settings``.

Capability parity with ``orchestrator/src/settings.rs`` (:53-96) minus the
cloud-SDK fields the environment rules out: runner selection (local
subprocesses vs an ssh fleet), host list, working/results directories, load
generation defaults.  JSON on disk so a testbed description can be checked
in and shared (the reference's ``settings.json``).  ``verifier`` defaults to
the port's ``cuda-only`` node kind, so a fleet made from default settings
runs on the card or fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..cli import DEFAULT_VERIFIER


@dataclass
class Settings:
    runner: str = "local"  # "local" | "ssh"
    hosts: List[str] = field(default_factory=list)  # ssh: 1 per node, may be user@host
    remote_repo: str = "."  # remote checkout path for the ssh runner
    repo_url: str = ""  # clone source for `fleet update` (settings.rs repo field)
    working_dir: str = "benchmark-fleet"
    results_dir: str = "benchmark-results"
    tps_per_node: int = 100
    transaction_size: int = 512
    verifier: str = DEFAULT_VERIFIER  # the JAX package's default: "cpu"
    # Testbed provisioning (settings.rs cloud_provider/token_file): "static"
    # claims hosts from ``hosts``; "rest" provisions via the JSON-REST cloud
    # client; "aws" via the EC2-surface client (providers.py — regions×AMIs,
    # security group, EC2 lifecycle states).  The API token is read from the
    # env var named by ``provider_token_env`` so checked-in settings never
    # carry secrets.
    provider: str = "static"  # "static" | "rest" | "aws"
    provider_base_url: str = ""
    provider_token_env: str = "CLOUD_API_TOKEN"
    provider_region: str = "ewr"
    provider_plan: str = "vc2-16c-64gb"
    # aws provider: region -> AMI map (settings.rs carries the same pairing
    # for its aws testbeds), instance type, and the ensured security group.
    provider_amis: Dict[str, str] = field(default_factory=dict)
    provider_instance_type: str = "m5d.8xlarge"
    provider_security_group: str = "mysticeti-tpu"

    def validate(self) -> None:
        if self.runner not in ("local", "ssh"):
            raise ValueError(f"unknown runner {self.runner!r}")
        if self.runner == "ssh" and not self.hosts:
            raise ValueError("ssh runner requires at least one host")
        if self.provider not in ("static", "rest", "aws"):
            raise ValueError(f"unknown provider {self.provider!r}")
        if self.provider in ("rest", "aws") and not self.provider_base_url:
            raise ValueError(
                f"{self.provider} provider requires provider_base_url"
            )
        if self.provider == "aws" and not self.provider_amis:
            raise ValueError(
                "aws provider requires provider_amis (region -> AMI)"
            )
        if (
            self.provider == "aws"
            and self.provider_region != "ewr"  # the untouched vultr default
            and self.provider_region not in self.provider_amis
        ):
            # An explicitly-set region with no AMI would silently fall back
            # to the first configured region — a whole fleet in the wrong
            # continent.  Fail the config loudly instead.
            raise ValueError(
                f"provider_region {self.provider_region!r} has no entry in "
                f"provider_amis (configured: {sorted(self.provider_amis)})"
            )

    def make_provider(self, state_path: Optional[str] = None,
                      transport=None):
        """Instantiate the configured ServerProvider (testbed.py seam)."""
        self.validate()
        if self.provider == "rest":
            from .providers import RestCloudProvider

            return RestCloudProvider(
                self.provider_base_url,
                token=os.environ.get(self.provider_token_env, ""),
                region=self.provider_region,
                plan=self.provider_plan,
                transport=transport,
            )
        if self.provider == "aws":
            from .providers import Ec2Provider

            return Ec2Provider(
                self.provider_base_url,
                token=os.environ.get(self.provider_token_env, ""),
                amis=self.provider_amis,
                instance_type=self.provider_instance_type,
                security_group=self.provider_security_group,
                default_region=(
                    self.provider_region
                    if self.provider_region in self.provider_amis
                    else None
                ),
                transport=transport,
            )
        from .testbed import StaticProvider

        return StaticProvider(self.hosts, state_path=state_path)

    def make_runner(self):
        """Instantiate the configured Runner (runner.py)."""
        self.validate()
        if self.runner == "local":
            from .runner import LocalProcessRunner

            return LocalProcessRunner(
                self.working_dir,
                tps_per_node=self.tps_per_node,
                transaction_size=self.transaction_size,
                verifier=self.verifier,
            )
        from .runner import SshRunner

        return SshRunner(
            self.hosts,
            remote_repo=self.remote_repo,
            working_dir=self.working_dir,
            tps_per_node=self.tps_per_node,
            verifier=self.verifier,
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Settings":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        settings = cls(**{k: v for k, v in raw.items() if k in known})
        settings.validate()
        return settings
