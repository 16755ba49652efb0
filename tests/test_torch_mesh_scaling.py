"""The port's ``mesh_scaling`` tool: sizes 1, 2 and 4 over ``["cpu"] * n``
(the counterpart of the JAX tool's virtual CPU devices), every lane valid
and the summed count equal to the batch at each size; a size larger than
the attached cards fails with a message, never dropped silently."""
import json

import pytest
import torch

from mysticeti_tpu_torch.ops import ed25519 as E
from mysticeti_tpu_torch.tools import mesh_scaling


def test_sizes_1_2_4_on_cpu_shards(tmp_path, capsys, monkeypatch):
    # One intra-op thread in each size's child: the plain versions gain
    # nothing from more, and the suite runs several workers on the cores.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "MULTICHIP_SCALING.json")
    assert mesh_scaling.main(["--sizes", "1", "2", "4", "--device", "cpu", "--batch", "8",
                              "--out", out]) == 0
    doc = json.loads(open(out).read())
    assert doc["metric"] == "sharded_verify_scaling_curve"
    assert doc["config"]["global_batch_fixed"] == 8 and doc["config"]["card"] is None
    points = doc["points"]
    assert [p["devices"] for p in points] == [1, 2, 4]
    for p in points:
        assert p["mesh"] == ["cpu"] * p["devices"]
        assert p["global_batch"] == 8 and p["per_shard_batch"] == 8 // p["devices"]
        assert p["psum_total_ok"] and p["step_s"] > 0 and p["sig_per_s"] > 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == points


def test_sizes_beyond_the_cards_fail_with_a_message(monkeypatch, capsys):
    monkeypatch.setattr(E, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ran = []
    monkeypatch.setattr(mesh_scaling, "run_point", lambda *a: ran.append(a))
    with pytest.raises(SystemExit) as exc:
        mesh_scaling.main(["--sizes", "1", "2", "4"])
    assert exc.value.code == 2 and ran == []
    assert "--sizes [2, 4] exceed the 1 attached card(s)" in capsys.readouterr().err


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_scaling.main(["--sizes", "1"])
