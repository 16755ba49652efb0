"""A real ``ServerProvider``: JSON-REST cloud provisioning client.

The port's copy of ``mysticeti_tpu.orchestrator.providers``.

Capability parity with the reference's cloud clients
(``orchestrator/src/client/vultr.rs:72-299`` — list/create/start/stop/
terminate over a bearer-token JSON API; ``client/aws.rs:37-393`` is the
same surface against EC2).  This environment has no cloud credentials and
zero egress, so the client is built the way the reference TESTS its
providers (``client/mod.rs:111-160`` ``TestClient``): all HTTP goes
through an injectable :class:`Transport`, and the test suite drives the
full testbed lifecycle against :class:`FixtureTransport` — recorded
request/response pairs — while :class:`UrllibTransport` serves real
deployments.

API shape (Vultr-flavored):

  GET    {base}/instances                 -> {"instances": [...]}
  POST   {base}/instances                 {"region", "plan", "label", "os_id"}
  POST   {base}/instances/{id}/start
  POST   {base}/instances/{id}/halt
  DELETE {base}/instances/{id}

Instances map to the orchestrator's :class:`~.testbed.Instance` via
``id`` / ``main_ip`` / ``region`` / ``power_status``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from .testbed import Instance, ServerProvider


class ProviderError(Exception):
    """A provider API call failed (client/mod.rs CloudProviderError)."""


class Transport:
    """One HTTP exchange: (method, url, body|None) -> (status, json-dict)."""

    async def request(self, method: str, url: str,
                      body: Optional[dict] = None,
                      headers: Optional[Dict[str, str]] = None
                      ) -> Tuple[int, dict]:
        raise NotImplementedError


class UrllibTransport(Transport):
    """Real HTTP via urllib in a worker thread (no extra dependencies).
    Only used with real credentials outside this zero-egress environment."""

    def __init__(self, timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s

    async def request(self, method, url, body=None, headers=None):
        import asyncio
        import urllib.error
        import urllib.request

        def call():
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(
                url, data=data, method=method, headers=headers or {}
            )
            if data is not None:
                req.add_header("Content-Type", "application/json")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    raw = r.read()
                    return r.status, json.loads(raw) if raw else {}
            except urllib.error.HTTPError as e:
                raw = e.read()
                try:
                    payload = json.loads(raw) if raw else {}
                except json.JSONDecodeError:
                    payload = {"error": raw.decode(errors="replace")}
                return e.code, payload

        return await asyncio.get_running_loop().run_in_executor(None, call)


class FixtureTransport(Transport):
    """Recorded request->response pairs (client/mod.rs:111-160 TestClient
    posture: the provider logic is tested end-to-end with no network).

    Fixtures: list of {"method", "url", "status", "response"} records;
    each is consumed at most ``repeat`` times (default: unlimited), matched
    on (method, url).  Every exchange is appended to ``calls`` so tests can
    assert the wire conversation — including request bodies.
    """

    def __init__(self, fixtures: Sequence[dict]) -> None:
        self.fixtures = list(fixtures)
        self.calls: List[dict] = []

    async def request(self, method, url, body=None, headers=None):
        self.calls.append(
            {"method": method, "url": url, "body": body}
        )
        for fx in self.fixtures:
            if fx["method"] == method and fx["url"] == url:
                remaining = fx.get("repeat")
                if remaining is not None:
                    if remaining <= 0:
                        continue
                    fx["repeat"] = remaining - 1
                return fx.get("status", 200), fx.get("response", {})
        raise AssertionError(f"no fixture for {method} {url}")


class RestCloudProvider(ServerProvider):
    """Cloud provisioning behind the ``ServerProvider`` seam
    (client/vultr.rs:72-299 capability)."""

    def __init__(
        self,
        base_url: str,
        token: str,
        region: str = "ewr",
        plan: str = "vc2-16c-64gb",
        os_id: int = 1743,
        label: str = "mysticeti-tpu",
        transport: Optional[Transport] = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.default_region = region
        self.plan = plan
        self.os_id = os_id
        self.label = label
        self.transport = transport or UrllibTransport()

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"}

    async def _call(self, method: str, path: str,
                    body: Optional[dict] = None) -> dict:
        status, payload = await self.transport.request(
            method, f"{self.base_url}{path}", body, self._headers()
        )
        if status >= 300:
            raise ProviderError(
                f"provider {method} {path} failed ({status}): {payload}"
            )
        return payload

    @staticmethod
    def _to_instance(raw: dict) -> Instance:
        return Instance(
            id=str(raw["id"]),
            host=raw.get("main_ip", ""),
            region=raw.get("region", ""),
            active=raw.get("power_status", "running") == "running",
        )

    # -- ServerProvider --

    async def list_instances(self) -> List[Instance]:
        payload = await self._call("GET", "/instances")
        return [
            self._to_instance(raw)
            for raw in payload.get("instances", [])
            if raw.get("label", self.label) == self.label
        ]

    async def create_instances(self, count: int, region: str) -> List[Instance]:
        created = []
        for _ in range(count):
            payload = await self._call(
                "POST",
                "/instances",
                {
                    "region": region or self.default_region,
                    "plan": self.plan,
                    "label": self.label,
                    "os_id": self.os_id,
                },
            )
            created.append(self._to_instance(payload["instance"]))
        return created

    async def start_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            await self._call("POST", f"/instances/{iid}/start")

    async def stop_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            await self._call("POST", f"/instances/{iid}/halt")

    async def terminate_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            await self._call("DELETE", f"/instances/{iid}")


# EC2 instance lifecycle states (client/aws.rs:37-393 drives the same set):
# pending/running count as active inventory; shutting-down/terminated
# instances are on their way out and never listed as claimable.
EC2_ACTIVE_STATES = frozenset({"pending", "running"})
EC2_GONE_STATES = frozenset({"shutting-down", "terminated"})


class Ec2Provider(ServerProvider):
    """AWS/EC2-surface provisioning behind the ``ServerProvider`` seam
    (``client/aws.rs:37-393`` capability): region-scoped inventory with a
    per-region AMI map, an ensured security group, and the EC2 instance
    lifecycle state machine (pending -> running -> stopping -> stopped,
    shutting-down -> terminated), all through the same injectable
    :class:`Transport` the REST provider uses — tested end-to-end against
    recorded fixtures, exactly like the reference's TestClient.

    API shape (EC2-flavored JSON surface; region scopes every path the way
    the EC2 endpoint hostname does):

      GET    {base}/{region}/instances            -> {"reservations": [
                                                       {"instances": [...]}]}
      POST   {base}/{region}/instances            (RunInstances)
      POST   {base}/{region}/instances/{id}/start
      POST   {base}/{region}/instances/{id}/stop
      DELETE {base}/{region}/instances/{id}       (TerminateInstances)
      GET    {base}/{region}/security-groups      -> {"security_groups": [...]}
      POST   {base}/{region}/security-groups      (create + authorize ingress)

    Instances map via ``instance_id`` / ``public_ip`` / ``state.name`` /
    ``placement.availability_zone``; ownership is claimed through the
    ``Name`` tag (aws.rs filters on the same tag).
    """

    def __init__(
        self,
        base_url: str,
        token: str,
        amis: Dict[str, str],
        instance_type: str = "m5d.8xlarge",
        security_group: str = "mysticeti-tpu",
        label: str = "mysticeti-tpu",
        default_region: Optional[str] = None,
        transport: Optional[Transport] = None,
    ) -> None:
        if not amis:
            raise ValueError("Ec2Provider needs a region -> AMI map")
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.amis = dict(amis)
        self.default_region = default_region or self.regions[0]
        self.instance_type = instance_type
        self.security_group = security_group
        self.label = label
        self.transport = transport or UrllibTransport()
        # id -> region: EC2 lifecycle calls are region-scoped, so the
        # provider remembers where each instance lives (refreshed by every
        # list/create; unknown ids trigger one inventory refresh).
        self._region_of: Dict[str, str] = {}
        self._sg_ready: Dict[str, bool] = {}

    @property
    def regions(self) -> List[str]:
        return sorted(self.amis)

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"}

    async def _call(self, method: str, path: str,
                    body: Optional[dict] = None) -> dict:
        status, payload = await self.transport.request(
            method, f"{self.base_url}{path}", body, self._headers()
        )
        if status >= 300:
            raise ProviderError(
                f"provider {method} {path} failed ({status}): {payload}"
            )
        return payload

    def _to_instance(self, raw: dict, region: str) -> Instance:
        iid = str(raw["instance_id"])
        self._region_of[iid] = region
        az = (raw.get("placement") or {}).get("availability_zone", "")
        return Instance(
            id=iid,
            host=raw.get("public_ip", ""),
            region=az or region,
            active=(raw.get("state") or {}).get("name") in EC2_ACTIVE_STATES,
        )

    def _owned(self, raw: dict) -> bool:
        """Ownership is the Name tag being PRESENT and equal (aws.rs filters
        the same way); an untagged foreign instance must never be claimed —
        a later ``destroy`` would terminate someone else's machine."""
        tags = {
            t.get("key"): t.get("value") for t in (raw.get("tags") or [])
        }
        return tags.get("Name") == self.label

    async def _ensure_security_group(self, region: str) -> None:
        """Describe-then-create (aws.rs creates its ``mysticeti`` group with
        the node/metrics ingress rules before the first RunInstances)."""
        if self._sg_ready.get(region):
            return
        payload = await self._call("GET", f"/{region}/security-groups")
        names = {
            g.get("group_name")
            for g in payload.get("security_groups", [])
        }
        if self.security_group not in names:
            await self._call(
                "POST",
                f"/{region}/security-groups",
                {
                    "group_name": self.security_group,
                    "description": "mysticeti-tpu benchmark fleet",
                    "ingress": [
                        {"protocol": "tcp", "port_range": "22"},
                        {"protocol": "tcp", "port_range": "1500-2000"},
                    ],
                },
            )
        self._sg_ready[region] = True

    # -- ServerProvider --

    async def list_instances(self) -> List[Instance]:
        out: List[Instance] = []
        for region in self.regions:
            payload = await self._call("GET", f"/{region}/instances")
            for reservation in payload.get("reservations", []):
                for raw in reservation.get("instances", []):
                    if not self._owned(raw):
                        continue
                    state = (raw.get("state") or {}).get("name")
                    if state in EC2_GONE_STATES:
                        continue
                    out.append(self._to_instance(raw, region))
        return out

    async def create_instances(self, count: int, region: str) -> List[Instance]:
        # "local" is the fleet CLI's placeholder default, not an EC2 region:
        # fall back to the configured default so `fleet deploy` works
        # without an explicit --region.  A genuinely unknown region still
        # errors loudly below.
        if region in (None, "", "local"):
            region = self.default_region
        ami = self.amis.get(region)
        if ami is None:
            raise ProviderError(
                f"no AMI configured for region {region!r} "
                f"(known: {self.regions})"
            )
        await self._ensure_security_group(region)
        payload = await self._call(
            "POST",
            f"/{region}/instances",
            {
                "image_id": ami,
                "instance_type": self.instance_type,
                "min_count": count,
                "max_count": count,
                "security_groups": [self.security_group],
                "tags": [{"key": "Name", "value": self.label}],
            },
        )
        return [
            self._to_instance(raw, region)
            for raw in payload.get("instances", [])
        ]

    async def _region_for(self, iid: str) -> str:
        region = self._region_of.get(iid)
        if region is None:
            await self.list_instances()  # refresh the id -> region map
            region = self._region_of.get(iid)
        if region is None:
            raise ProviderError(f"unknown instance id {iid!r}")
        return region

    async def start_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            region = await self._region_for(iid)
            await self._call("POST", f"/{region}/instances/{iid}/start")

    async def stop_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            region = await self._region_for(iid)
            await self._call("POST", f"/{region}/instances/{iid}/stop")

    async def terminate_instances(self, ids: Sequence[str]) -> None:
        for iid in ids:
            region = await self._region_for(iid)
            await self._call("DELETE", f"/{region}/instances/{iid}")
            self._region_of.pop(iid, None)
