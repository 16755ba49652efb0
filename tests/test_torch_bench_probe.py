"""The port's ``bench_probe`` against the JAX package's tool: the record
has every key the JAX tool writes, here on the kernels' plain versions
(``--device cpu``) at a small ``BENCH_BATCH``; without a card the tool
raises instead of measuring the host."""
import json
import os
import re

import pytest

from mysticeti_tpu_torch.tools import bench_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain keyed chain gains nothing from intra-op threads (its time
    is Python dispatch), and the suite runs several workers on the host's
    cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool_keys():
    with open(os.path.join(REPO, "tools", "bench_probe.py")) as f:
        return set(re.findall(r'out\["(\w+)"\]', f.read())) | {"device"}


def test_the_record_has_the_jax_tools_keys(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BATCH", "256")
    assert bench_probe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    keys = _jax_tool_keys()
    assert keys == {"device", "null_rtt_ms", "h2d_MBps", "kernel_ms_per_batch",
                    "kernel_only_sig_s", "blob_bytes_per_batch", "e2e_sig_s_16iters",
                    "e2e_ms_per_batch"}
    assert keys <= set(record)
    assert all(record[k] > 0 for k in keys - {"device"})
    assert record["device"] == "cpu" and record["backend"] == "cpu" and record["card"] is None
    assert record["batch"] == 256 and record["blob_bytes_per_batch"] == 256 * 26 * 4
    # The plain versions count no launch.
    assert set(record["launches"].values()) == {0}


def test_the_probe_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_probe.probe()
