"""The port's ``wal_inspect`` tool: the counterpart of
``tests/test_storage_lifecycle.py::test_wal_inspect_tool`` over a WAL the
port's chaos harness wrote, and parity with the JAX package's tool: over
the same healthy, torn and broken WAL both give equal ``--json`` documents,
equal text and equal exit codes."""
import json
import os
import subprocess
import sys

import pytest

from mysticeti_tpu_torch.chaos import FaultPlan, run_chaos_sim
from mysticeti_tpu_torch.config import Parameters, StorageParameters
from mysticeti_tpu_torch.storage import checkpoint_files
from mysticeti_tpu_torch.tools import wal_inspect as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import wal_inspect as jax_tool  # noqa: E402

pytestmark = pytest.mark.storage


def _params(**storage_kwargs):
    defaults = dict(segment_bytes=16 * 1024, checkpoint_interval=5, gc_depth=20)
    defaults.update(storage_kwargs)
    return Parameters(leader_timeout_s=1.0, storage=StorageParameters(**defaults))


@pytest.fixture(scope="module")
def wal_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wal-inspect")
    run_chaos_sim(FaultPlan(seed=3), 4, 14.0, str(root), parameters=_params(),
                  with_metrics=True)
    return root


def _tear_sealed(wal_dir):
    segments = sorted(n for n in os.listdir(wal_dir) if n.startswith("wal."))
    victim = os.path.join(wal_dir, segments[0])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 6)


def _corrupt_checkpoints(wal_dir):
    for ckpt in checkpoint_files(wal_dir):
        with open(ckpt, "r+b") as f:
            f.seek(8)
            f.write(b"\x00" * 8)


def test_wal_inspect_tool(wal_root):
    wal_dir = os.path.join(str(wal_root), "wal-0")

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "mysticeti_tpu_torch.tools.wal_inspect", *args],
            capture_output=True, text=True, cwd=REPO,
        )

    healthy = run(wal_dir, "--json")
    assert healthy.returncode == 0, healthy.stdout + healthy.stderr
    doc = json.loads(healthy.stdout)
    assert doc["layout"] == "segmented"
    assert doc["checkpoints"] and doc["checkpoints"][0]["valid"]
    assert doc["census"]["block"]["entries"] > 0
    # Tear a SEALED segment: unreplayable -> exit 2 with a diagnosis.
    _tear_sealed(wal_dir)
    torn = run(wal_dir)
    assert torn.returncode == 2
    assert "SEALED" in torn.stdout
    # GC'd history with every checkpoint corrupted -> exit 3.
    _corrupt_checkpoints(wal_dir)
    broken = run(wal_dir)
    assert broken.returncode in (2, 3)
    assert "UNREPLAYABLE" in broken.stdout or "SEALED" in broken.stdout


def _both(capsys, *args):
    """(exit code, stdout) of the port's tool and of the JAX tool."""
    out = []
    for tool in (port, jax_tool):
        rc = tool.main(list(args))
        out.append((rc, capsys.readouterr().out))
    return out


def test_reports_equal_the_jax_tools(wal_root, capsys):
    wal_dir = os.path.join(str(wal_root), "wal-1")
    states = []
    for damage in (None, _tear_sealed, _corrupt_checkpoints):
        if damage is not None:
            damage(wal_dir)
        (rc, text), (jax_rc, jax_text) = _both(capsys, wal_dir)
        (json_rc, doc), (jax_json_rc, jax_doc) = _both(capsys, wal_dir, "--json")
        assert (rc, text) == (jax_rc, jax_text)
        assert json_rc == jax_json_rc == rc
        assert json.loads(doc) == json.loads(jax_doc)
        states.append(rc)
    assert states[0] == 0 and states[1] == 2 and states[2] in (2, 3)


def test_missing_manifest_and_single_file(tmp_path, wal_root, capsys):
    """Exit 4 on a directory without a manifest or a path that is neither
    file nor directory; a legacy single file replays."""
    (rc, text), jax = _both(capsys, str(tmp_path))
    assert (rc, text) == jax and rc == 4
    missing = str(tmp_path / "nowhere")
    (rc, text), jax = _both(capsys, missing)
    assert (rc, text) == jax and rc == 4
    wal_dir = os.path.join(str(wal_root), "wal-2")
    segment = os.path.join(wal_dir, sorted(n for n in os.listdir(wal_dir)
                                           if n.startswith("wal."))[-1])
    (rc, doc), (jax_rc, jax_doc) = _both(capsys, segment, "--json")
    assert rc == jax_rc and json.loads(doc) == json.loads(jax_doc)
    assert json.loads(doc)["layout"] == "single-file"
