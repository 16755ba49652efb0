"""The port's cloud providers behind the ServerProvider seam, tested the way
the reference tests its cloud clients (client/mod.rs:111-160 TestClient):
the full testbed lifecycle runs against recorded request/response fixtures —
no network, real provider logic.

Counterparts of ``tests/test_providers.py``, and each lifecycle's wire
conversation (every method, URL and body, in order) held to the JAX
package's on the same fixtures."""
import asyncio
import importlib

import pytest

from mysticeti_tpu_torch.orchestrator.providers import (
    Ec2Provider,
    FixtureTransport,
    ProviderError,
    RestCloudProvider,
)
from mysticeti_tpu_torch.orchestrator.testbed import Testbed

BASE = "https://api.cloud.example/v2"


def _inst(iid, ip, power="running", label="mysticeti-tpu"):
    return {
        "id": iid, "main_ip": ip, "region": "ewr",
        "power_status": power, "label": label,
    }


def _fixtures():
    created = [_inst("abc1", "10.0.0.1"), _inst("abc2", "10.0.0.2")]
    return [
        {"method": "POST", "url": f"{BASE}/instances", "repeat": 1,
         "response": {"instance": created[0]}},
        {"method": "POST", "url": f"{BASE}/instances", "repeat": 1,
         "response": {"instance": created[1]}},
        {"method": "GET", "url": f"{BASE}/instances",
         "response": {"instances": created + [
             # Another tenant's machine: must be filtered out by label.
             _inst("zzz9", "10.9.9.9", label="other-project"),
         ]}},
        {"method": "POST", "url": f"{BASE}/instances/abc1/start", "response": {}},
        {"method": "POST", "url": f"{BASE}/instances/abc2/start", "response": {}},
        {"method": "POST", "url": f"{BASE}/instances/abc1/halt", "response": {}},
        {"method": "POST", "url": f"{BASE}/instances/abc2/halt", "response": {}},
        {"method": "DELETE", "url": f"{BASE}/instances/abc1", "response": {}},
        {"method": "DELETE", "url": f"{BASE}/instances/abc2", "response": {}},
    ]


def _provider(transport):
    return RestCloudProvider(BASE, token="tok-123", transport=transport)


def test_testbed_lifecycle_end_to_end():
    """deploy / status / start / stop / destroy through the Testbed CLI
    surface, against the fixture transport."""
    transport = FixtureTransport(_fixtures())
    tb = Testbed(_provider(transport))

    async def scenario():
        created = await tb.deploy(2, "ewr")
        assert [i.host for i in created] == ["10.0.0.1", "10.0.0.2"]
        insts = await tb.status()
        assert [i.id for i in insts] == ["abc1", "abc2"]  # label-filtered
        await tb.start()
        await tb.stop()
        await tb.destroy()

    asyncio.run(scenario())
    # The recorded wire conversation: create carries the full body; the
    # lifecycle ops hit the per-instance endpoints.
    assert transport.calls[0]["body"] == {
        "region": "ewr", "plan": "vc2-16c-64gb",
        "label": "mysticeti-tpu", "os_id": 1743,
    }
    methods = [(c["method"], c["url"].rsplit("/v2", 1)[1])
               for c in transport.calls]
    assert ("POST", "/instances/abc1/start") in methods
    assert ("POST", "/instances/abc2/halt") in methods
    assert ("DELETE", "/instances/abc1") in methods


def test_api_error_raises_provider_error():
    transport = FixtureTransport([
        {"method": "GET", "url": f"{BASE}/instances", "status": 401,
         "response": {"error": "invalid API token"}},
    ])
    with pytest.raises(ProviderError, match="401"):
        asyncio.run(_provider(transport).list_instances())


# -- AWS/EC2-surface provider (client/aws.rs:37-393 capability) ---------------

EC2 = "https://ec2.cloud.example"
AMIS = {"us-east-1": "ami-east", "eu-west-1": "ami-west"}


def _ec2_inst(iid, ip, state="running", az="us-east-1a", name="mysticeti-tpu"):
    return {
        "instance_id": iid,
        "public_ip": ip,
        "state": {"name": state},
        "placement": {"availability_zone": az},
        "tags": [{"key": "Name", "value": name}],
    }


def _ec2_fixtures():
    east = [
        _ec2_inst("i-e1", "3.0.0.1"),
        # Lifecycle states: pending counts as active inventory...
        _ec2_inst("i-e2", "3.0.0.2", state="pending"),
        # ...terminated/shutting-down never list; foreign tags filter out.
        _ec2_inst("i-zz", "3.9.9.9", state="terminated"),
        _ec2_inst("i-other", "3.8.8.8", name="someone-else"),
    ]
    west = [_ec2_inst("i-w1", "5.0.0.1", state="stopped", az="eu-west-1b")]
    return [
        # Security group: east must be created (describe finds none), west
        # already exists.
        {"method": "GET", "url": f"{EC2}/us-east-1/security-groups",
         "response": {"security_groups": []}},
        {"method": "POST", "url": f"{EC2}/us-east-1/security-groups",
         "response": {"group_id": "sg-123"}},
        {"method": "GET", "url": f"{EC2}/eu-west-1/security-groups",
         "response": {"security_groups": [{"group_name": "mysticeti-tpu"}]}},
        # RunInstances per region.
        {"method": "POST", "url": f"{EC2}/us-east-1/instances", "repeat": 1,
         "response": {"instances": east[:2]}},
        {"method": "POST", "url": f"{EC2}/eu-west-1/instances", "repeat": 1,
         "response": {"instances": west}},
        # DescribeInstances (region-scoped, reservation-nested).
        {"method": "GET", "url": f"{EC2}/us-east-1/instances",
         "response": {"reservations": [{"instances": east}]}},
        {"method": "GET", "url": f"{EC2}/eu-west-1/instances",
         "response": {"reservations": [{"instances": west}]}},
        # Lifecycle ops.
        {"method": "POST", "url": f"{EC2}/us-east-1/instances/i-e1/start",
         "response": {}},
        {"method": "POST", "url": f"{EC2}/us-east-1/instances/i-e2/start",
         "response": {}},
        {"method": "POST", "url": f"{EC2}/eu-west-1/instances/i-w1/start",
         "response": {}},
        {"method": "POST", "url": f"{EC2}/us-east-1/instances/i-e1/stop",
         "response": {}},
        {"method": "POST", "url": f"{EC2}/us-east-1/instances/i-e2/stop",
         "response": {}},
        {"method": "POST", "url": f"{EC2}/eu-west-1/instances/i-w1/stop",
         "response": {}},
        {"method": "DELETE", "url": f"{EC2}/us-east-1/instances/i-e1",
         "response": {}},
        {"method": "DELETE", "url": f"{EC2}/us-east-1/instances/i-e2",
         "response": {}},
        {"method": "DELETE", "url": f"{EC2}/eu-west-1/instances/i-w1",
         "response": {}},
    ]


def test_ec2_testbed_lifecycle_end_to_end():
    """deploy (both regions) / status / start / stop / destroy through the
    Testbed surface against recorded EC2-shaped fixtures: security-group
    ensure, regions x AMIs, lifecycle state mapping, tag ownership."""
    transport = FixtureTransport(_ec2_fixtures())
    provider = Ec2Provider(EC2, token="tok-ec2", amis=AMIS, transport=transport)
    tb = Testbed(provider)

    async def scenario():
        east = await tb.deploy(2, "us-east-1")
        assert [i.host for i in east] == ["3.0.0.1", "3.0.0.2"]
        west = await tb.deploy(1, "eu-west-1")
        assert [i.id for i in west] == ["i-w1"]
        insts = await tb.status()
        # terminated + foreign-tag instances filtered; stopped still listed.
        assert sorted(i.id for i in insts) == ["i-e1", "i-e2", "i-w1"]
        by_id = {i.id: i for i in insts}
        assert by_id["i-e2"].active  # pending counts as active
        assert not by_id["i-w1"].active  # stopped does not
        assert by_id["i-w1"].region == "eu-west-1b"
        await tb.start()
        await tb.stop()
        await tb.destroy()

    asyncio.run(scenario())
    # The wire conversation: security group ensured before the first
    # RunInstances, and the create body pins the region's AMI + tags.
    urls = [(c["method"], c["url"]) for c in transport.calls]
    assert urls.index(("GET", f"{EC2}/us-east-1/security-groups")) < urls.index(
        ("POST", f"{EC2}/us-east-1/instances")
    )
    assert ("POST", f"{EC2}/us-east-1/security-groups") in urls
    # West's group already existed: no create call for it.
    assert ("POST", f"{EC2}/eu-west-1/security-groups") not in urls
    run_body = next(
        c["body"] for c in transport.calls
        if c["url"] == f"{EC2}/us-east-1/instances" and c["method"] == "POST"
    )
    assert run_body["image_id"] == "ami-east"
    assert run_body["min_count"] == run_body["max_count"] == 2
    assert run_body["tags"] == [{"key": "Name", "value": "mysticeti-tpu"}]
    # Region-scoped lifecycle ops for every instance.
    assert ("POST", f"{EC2}/eu-west-1/instances/i-w1/start") in urls
    assert ("DELETE", f"{EC2}/us-east-1/instances/i-e1") in urls


def test_ec2_default_region_fallback_for_cli_placeholder():
    """`fleet deploy` passes the CLI's \"local\" placeholder when --region is
    omitted; the provider must fall back to its default region instead of
    failing the lookup (an explicit unknown region still errors)."""
    transport = FixtureTransport([
        {"method": "GET", "url": f"{EC2}/eu-west-1/security-groups",
         "response": {"security_groups": [{"group_name": "mysticeti-tpu"}]}},
        {"method": "POST", "url": f"{EC2}/eu-west-1/instances",
         "response": {"instances": [_ec2_inst("i-d1", "5.0.0.9",
                                              az="eu-west-1a")]}},
    ])
    provider = Ec2Provider(
        EC2, token="t", amis=AMIS, default_region="eu-west-1",
        transport=transport,
    )
    created = asyncio.run(provider.create_instances(1, "local"))
    assert [i.id for i in created] == ["i-d1"]
    body = transport.calls[-1]["body"]
    assert body["image_id"] == "ami-west"


def test_ec2_unknown_region_and_unknown_id():
    transport = FixtureTransport([
        {"method": "GET", "url": f"{EC2}/us-east-1/instances",
         "response": {"reservations": []}},
        {"method": "GET", "url": f"{EC2}/eu-west-1/instances",
         "response": {"reservations": []}},
    ])
    provider = Ec2Provider(EC2, token="t", amis=AMIS, transport=transport)
    with pytest.raises(ProviderError, match="no AMI"):
        asyncio.run(provider.create_instances(1, "ap-south-2"))
    # Unknown id: one inventory refresh, then a loud error.
    with pytest.raises(ProviderError, match="unknown instance id"):
        asyncio.run(provider.start_instances(["i-ghost"]))


def test_ec2_api_error_raises_provider_error():
    transport = FixtureTransport([
        {"method": "GET", "url": f"{EC2}/us-east-1/instances", "status": 403,
         "response": {"error": "UnauthorizedOperation"}},
    ])
    provider = Ec2Provider(
        EC2, token="t", amis={"us-east-1": "ami-east"}, transport=transport
    )
    with pytest.raises(ProviderError, match="403"):
        asyncio.run(provider.list_instances())


def test_settings_wires_the_ec2_provider(monkeypatch, tmp_path):
    from mysticeti_tpu_torch.orchestrator.settings import Settings

    monkeypatch.setenv("CLOUD_API_TOKEN", "aws-env-token")
    s = Settings(
        provider="aws", provider_base_url=EC2, provider_amis=dict(AMIS),
        provider_instance_type="c5.large",
    )
    p = s.make_provider()
    assert isinstance(p, Ec2Provider)
    assert p.token == "aws-env-token"
    assert p.instance_type == "c5.large"
    assert p.regions == ["eu-west-1", "us-east-1"]
    # provider_region default ("ewr") is not an EC2 region in the AMI map:
    # the default region falls back to the first configured region.
    assert p.default_region == "eu-west-1"
    # Round-trips through JSON (amis survive; the secret never lands).
    path = str(tmp_path / "settings.json")
    s.save(path)
    assert "aws-env-token" not in open(path).read()
    loaded = Settings.load(path)
    assert isinstance(loaded.make_provider(), Ec2Provider)
    assert loaded.provider_amis == AMIS

    with pytest.raises(ValueError, match="provider_amis"):
        Settings(provider="aws", provider_base_url=EC2).validate()
    with pytest.raises(ValueError, match="provider_base_url"):
        Settings(provider="aws", provider_amis=AMIS).validate()
    # An explicitly-set region with no configured AMI is a loud config
    # error, never a silent fallback to another continent.
    with pytest.raises(ValueError, match="no entry in provider_amis"):
        Settings(
            provider="aws", provider_base_url=EC2, provider_amis=dict(AMIS),
            provider_region="us-west-2",
        ).validate()


def test_settings_wires_the_rest_provider(monkeypatch, tmp_path):
    from mysticeti_tpu_torch.orchestrator.settings import Settings

    monkeypatch.setenv("CLOUD_API_TOKEN", "from-env")
    s = Settings(provider="rest", provider_base_url=BASE)
    p = s.make_provider()
    assert isinstance(p, RestCloudProvider)
    assert p.token == "from-env"
    # Round-trips through JSON without ever storing the secret.
    path = str(tmp_path / "settings.json")
    s.save(path)
    assert "from-env" not in open(path).read()
    assert isinstance(Settings.load(path).make_provider(), RestCloudProvider)

    with pytest.raises(ValueError, match="provider_base_url"):
        Settings(provider="rest").validate()


def _conversations(scenario):
    """Run ``scenario(providers_module, testbed_module)`` once a package;
    returns each package's recorded wire conversation and the scenario's
    return value."""
    out = []
    for pkg in ("mysticeti_tpu", "mysticeti_tpu_torch"):
        providers = importlib.import_module(f"{pkg}.orchestrator.providers")
        testbed = importlib.import_module(f"{pkg}.orchestrator.testbed")
        out.append(scenario(providers, testbed))
    return out


def test_rest_lifecycle_conversation_equals_the_jax_packages(capsys):
    def scenario(providers, testbed):
        transport = providers.FixtureTransport(_fixtures())
        tb = testbed.Testbed(providers.RestCloudProvider(BASE, token="t", transport=transport))

        async def lifecycle():
            created = await tb.deploy(2, "ewr")
            listed = await tb.status()
            await tb.start()
            await tb.stop()
            await tb.destroy()
            return [(i.id, i.host, i.region, i.active) for i in created + listed]

        return asyncio.run(lifecycle()), transport.calls

    port, jax = _conversations(scenario)
    assert port == jax
    assert len(port[1]) == 2 + 1 + 3 * 3
    out = capsys.readouterr().out
    assert out.count("| abc1 | 10.0.0.1 | ewr    | running |") == 2


def test_ec2_lifecycle_conversation_equals_the_jax_packages(capsys):
    def scenario(providers, testbed):
        transport = providers.FixtureTransport(_ec2_fixtures())
        provider = providers.Ec2Provider(EC2, token="t", amis=AMIS, transport=transport)
        tb = testbed.Testbed(provider)

        async def lifecycle():
            created = await tb.deploy(2, "us-east-1") + await tb.deploy(1, "eu-west-1")
            listed = await tb.status()
            await tb.start()
            await tb.stop()
            await tb.destroy()
            errors = []
            for call in (provider.create_instances(1, "ap-south-2"),
                         provider.start_instances(["i-ghost"])):
                try:
                    await call
                except providers.ProviderError as exc:
                    errors.append(str(exc))
            return [(i.id, i.host, i.region, i.active) for i in created + listed], errors

        return asyncio.run(lifecycle()), transport.calls

    port, jax = _conversations(scenario)
    assert port == jax
    assert len(port[0][1]) == 2
