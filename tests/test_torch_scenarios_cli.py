"""The port's ``scenarios`` subcommand and ``scenario_matrix`` tool against
the JAX package's: with ``--verifier sim-oracle`` they print and write what
the JAX package's do, ``--list`` lists the same matrix, and both verify on
the card unless they are asked otherwise.
"""
import dataclasses
import json

import pytest

from mysticeti_tpu_torch import scenarios

pytestmark = pytest.mark.byzantine


def _byzantine_at_f(module, duration_s):
    return dataclasses.replace(module.scenario_by_name("byzantine-at-f"),
                               duration_s=duration_s)


def test_scenarios_cli_output_equals_the_jax_clis(tmp_path, capsys):
    """``scenarios --verifier sim-oracle`` prints and writes what the JAX
    CLI does, and ``--list`` lists the same matrix."""
    from mysticeti_tpu.cli import main as jax_main
    from mysticeti_tpu_torch.cli import main

    assert jax_main(["scenarios", "--list"]) == 0
    want = capsys.readouterr().out
    assert main(["scenarios", "--list"]) == 0
    assert capsys.readouterr().out == want
    args = ["scenarios", "--scenario", "byzantine-at-f", "--duration", "2", "--seed", "3"]
    rc = jax_main(args + ["--out", str(tmp_path / "jax.json")])
    want = capsys.readouterr().out
    assert main(args + ["--out", str(tmp_path / "port.json"), "--verifier", "sim-oracle"]) == rc
    got = capsys.readouterr().out
    assert got.replace("port.json", "jax.json") == want
    assert "byzantine-at-f" in got and "matrix: " in got
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_scenarios_cli_defaults_to_the_card(tmp_path):
    """With no ``--verifier`` every node verifies on the card: without one,
    ``scenarios`` raises before the first twin."""
    import torch

    from mysticeti_tpu_torch.cli import build_parser, main

    assert build_parser().parse_args(["scenarios"]).verifier == "cuda-only"
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default kind would run")
    with pytest.raises(RuntimeError):
        main(["scenarios", "--scenario", "byzantine-at-f", "--duration", "1",
              "--working-directory", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


def test_scenario_matrix_tool_equals_the_jax_tools(tmp_path, monkeypatch, capsys):
    """``python -m mysticeti_tpu_torch.tools.scenario_matrix --scenario
    byzantine-at-f`` (the scenario cut to 1 virtual s) writes the JAX
    tool's document (its wall seconds aside), determinism leg included."""
    import sys

    from mysticeti_tpu import scenarios as J
    from mysticeti_tpu_torch.tools import scenario_matrix as port_tool

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    from tools import scenario_matrix as jax_tool

    docs = {}
    for name, tool, module, extra in (("jax", jax_tool, J, []),
                                      ("port", port_tool, scenarios, ["--verifier", "sim-oracle"])):
        short = _byzantine_at_f(module, 1.0)
        monkeypatch.setattr(tool, "scenario_by_name", lambda _name, s=short: s)
        out = tmp_path / f"{name}.json"
        tool.main(["--scenario", "byzantine-at-f", "--out", str(out)] + extra)
        docs[name] = json.loads(out.read_text())
        docs[name].pop("wall_s")
    assert docs["port"] == docs["jax"]
    assert docs["port"]["determinism"]["byte_identical"]
    assert docs["port"]["verifier"] == "sim-resign-oracle"
    capsys.readouterr()


def test_scenario_matrix_tool_defaults_to_the_card(tmp_path, monkeypatch):
    """With no ``--verifier`` (or with the JAX tool's ``--real-crypto``) the
    tool verifies on the card: without one it raises before the first
    twin, and it writes no document."""
    import torch

    from mysticeti_tpu_torch.tools import scenario_matrix as tool

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default kind would run")
    monkeypatch.setattr(tool, "scenario_by_name",
                        lambda _name: _byzantine_at_f(scenarios, 1.0))
    for extra in ([], ["--real-crypto"]):
        out = tmp_path / "card.json"
        with pytest.raises(RuntimeError):
            tool.main(["--scenario", "byzantine-at-f", "--out", str(out)] + extra)
        assert not out.exists()


def test_scenario_matrix_tool_runs_both_legs_through_the_verifier(tmp_path, monkeypatch, capsys):
    """``--verifier cpu``: the matrix run and both determinism runs give
    every node the ``cpu`` kind, whose verdicts are the oracle's, so the
    digests equal the sim-oracle run's."""
    from mysticeti_tpu_torch.tools import scenario_matrix as tool

    kinds = []
    factory = scenarios.verifier_factory

    def spy(kind, *args, **kwargs):
        kinds.append(kind)
        return factory(kind, *args, **kwargs)

    monkeypatch.setattr(scenarios, "verifier_factory", spy)
    monkeypatch.setattr(tool, "scenario_by_name",
                        lambda _name: _byzantine_at_f(scenarios, 1.0))
    docs = {}
    for kind in ("cpu", "sim-oracle"):
        out = tmp_path / f"{kind}.json"
        assert tool.main(["--scenario", "byzantine-at-f", "--out", str(out),
                          "--verifier", kind]) == 0
        docs[kind] = json.loads(out.read_text())
    assert kinds == ["cpu"] * 3 + ["sim-oracle"] * 3
    assert docs["cpu"]["verifier"] == "cpu"
    assert docs["cpu"]["determinism"] == docs["sim-oracle"]["determinism"]
    assert docs["cpu"]["determinism"]["byte_identical"]
    assert [v["digests"] for v in docs["cpu"]["scenarios"]] == [
        v["digests"] for v in docs["sim-oracle"]["scenarios"]]
    capsys.readouterr()
