"""``python -m mysticeti_tpu_torch.tools.reconfig_matrix --no-matrix
--no-determinism --verifier cpu``: the live leg on the ``cpu`` kind (its own
file: four validators over real sockets), its schedule shortened (``
LIVE_SCHEDULE_S``), on free ports: validator 3 is activated by a committed
ADD, boots from an empty WAL and catches up; validator 2 is removed and
stopped while its peers run on.  Every survivor reaches epoch 2, the joiner
commits, the committed sequences are prefixes of one.  Also the stop it
needs: on Python 3.12 a ``TcpNetwork`` whose dialers outlive it still
stops (``Server.wait_closed`` waits for its accepted connections)."""
import asyncio
import json
import os

import pytest

import mysticeti_tpu_torch.network as PN
from mysticeti_tpu_torch import config as port_config
from mysticeti_tpu_torch.tools import reconfig_matrix
from test_torch_cli import _free_port_base
from test_torch_fleet_bench_parity import clean_env  # noqa: F401
from test_torch_network import _exchange, _start_pair

SHORT = {"warmup": 4.0, "add": 2.0, "join": 4.0, "remove": 3.0, "retire": 3.0}


def test_the_live_leg_crosses_both_boundaries_on_the_cpu_kind(tmp_path, monkeypatch, clean_env):
    monkeypatch.setattr(reconfig_matrix, "LIVE_SCHEDULE_S", SHORT)
    # ``--port-base`` moves benchmark-genesis's ports for the process.
    monkeypatch.setattr(port_config, "DEFAULT_PORT_BASE", port_config.DEFAULT_PORT_BASE)
    out = tmp_path / "RECONFIG.json"
    for attempt in range(2):
        rc = reconfig_matrix.main([
            "--no-matrix", "--no-determinism", "--verifier", "cpu",
            "--port-base", str(_free_port_base(4)), "--workdir", str(tmp_path / "live"),
            "--out", str(out)])
        doc = json.loads(out.read_text())
        if doc["live"]["passed"]:
            break
    live = doc["live"]
    assert rc == 0 and live["passed"], live
    assert live["epochs_reached"] >= 2 and live["epochs"]["2"] >= 1
    assert set(live["epochs"]) == {"0", "1", "2", "3"}
    assert live["joiner_commits"] > 0 and live["prefix_consistent"]
    assert live["commits"]["2"] < live["commits"]["0"]
    assert live["verifier"] == "cpu" and live["tps"] == 20 and live["nodes"] == 4
    assert live["launches"] == {"prologue": 0, "prologue_flat": 0, "verify_generic": 0,
                                "verify_keyed": 0}
    assert doc["scenarios"] == [] and doc["all_pass"] and "determinism" not in doc
    assert doc["verifier"] == "cpu" and doc["card"] is None and doc["revision"] == "r18"
    assert os.path.isdir(tmp_path / "live" / "validator-3")


def test_the_node_kind_of_the_jax_tools_run():
    from mysticeti_tpu_torch.scenarios import ORACLE_KIND
    from mysticeti_tpu_torch.tools import node_kind

    assert node_kind(ORACLE_KIND) == "cpu"
    assert node_kind("cuda-only") == "cuda-only" and node_kind("cpu") == "cpu"


@pytest.mark.parametrize("accepting", [True, False])
def test_a_network_stops_while_its_peer_runs_on(accepting):
    """Stopping one endpoint of a live connection, the one that accepted it
    or the one that dialed, returns promptly while the other keeps
    running."""

    async def main():
        net0, net1, conn0, conn1 = await _start_pair(PN.TcpNetwork, PN.TcpNetwork)
        try:
            got = await _exchange(conn0, conn1, [PN.Blocks((b"x" * 10,))], 1)
            assert bytes(got[0].blocks[0]) == b"x" * 10
            stopping, running = (net1, net0) if accepting else (net0, net1)
            await asyncio.wait_for(stopping.stop(), 10)
            assert not running._stopped
        finally:
            await asyncio.wait_for(net0.stop(), 10)
            await asyncio.wait_for(net1.stop(), 10)

    asyncio.run(main())
