"""``reconfig_matrix``'s determinism leg in the port and in the JAX
repository's tool, both patched the same way (its own file: four 10-node
sims a side): ``reconfig-continuous-churn`` cut to a few virtual seconds,
its first boundary inside them, run twice on the sim re-sign oracle by each
tool.  Each tool's two runs are byte-identical and the port's digests equal
the JAX tool's."""
import dataclasses

from mysticeti_tpu_torch import scenarios as port_scenarios
from mysticeti_tpu_torch.tools import reconfig_matrix
from test_torch_fleet_bench_parity import jax_tool

VIRTUAL_S = 4.0
NAME = "reconfig-continuous-churn"


def test_determinism_leg_equals_the_jax_tools(monkeypatch):
    jax = jax_tool("reconfig_matrix")
    churn = port_scenarios.scenario_by_name(NAME).churn
    assert min(event.at_s for event in churn) < VIRTUAL_S

    def shortened(lookup):
        return lambda name: dataclasses.replace(lookup(name), duration_s=VIRTUAL_S)

    monkeypatch.setattr(jax, "scenario_by_name", shortened(jax.scenario_by_name))
    monkeypatch.setattr(reconfig_matrix, "scenario_by_name",
                        shortened(reconfig_matrix.scenario_by_name))
    want = jax.determinism_leg(NAME)
    got = reconfig_matrix.determinism_leg(NAME, "sim-oracle")
    assert want["byte_identical"] and got["byte_identical"]
    assert got == want
