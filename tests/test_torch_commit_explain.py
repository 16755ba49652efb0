"""The port's ``commit_explain`` tool: ``--url`` against a live port node
on loopback (four ``accept``-kind validators; node 0 serves
``/debug/consensus``), and, over that node's dumped document, ``--file``
output and exit codes equal to the JAX package's tool for every way of
asking (the last N, skips only, a named slot in both spellings, an absent
slot: exit 1)."""
import asyncio
import json
import os
import subprocess
import sys
import urllib.request

import pytest

from mysticeti_tpu_torch.tools import commit_explain as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_validator import _setup, _start_all, _wait_commits  # noqa: E402
from tools import commit_explain as jax_tool  # noqa: E402

pytestmark = pytest.mark.finality


def _live_node(tmp_path):
    """(the tool's ``--url --last 5`` child, node 0's /debug/consensus
    document), both taken while the fleet runs."""

    async def main():
        committee, parameters, signers, privates = _setup(tmp_path, 4)
        validators = await _start_all(committee, parameters, signers, privates, 4)
        try:
            await _wait_commits(validators, minimum=4, timeout_s=60)
            url = f"http://127.0.0.1:{parameters.metrics_address(0)[1]}"
            live = await asyncio.to_thread(
                subprocess.run,
                [sys.executable, "-m", "mysticeti_tpu_torch.tools.commit_explain", "--url", url,
                 "--last", "5"], cwd=REPO, capture_output=True, text=True, timeout=60)

            def fetch():
                with urllib.request.urlopen(url + "/debug/consensus", timeout=10) as resp:
                    return json.loads(resp.read().decode())

            return live, await asyncio.to_thread(fetch)
        finally:
            for v in validators:
                await v.stop()

    return asyncio.run(main())


def test_live_node_and_its_dump_explain_as_the_jax_tool(tmp_path, capsys):
    live, doc = _live_node(tmp_path)
    assert live.returncode == 0, live.stderr
    lines = live.stdout.splitlines()
    assert lines[0].startswith("# authority=0 ")
    slots = [line for line in lines if line.startswith("slot ")]
    assert 1 <= len(slots) <= 5
    assert all(line.endswith((" via the direct rule", " via the indirect rule")) for line in slots)

    records = doc["records"]
    assert records
    dump = str(tmp_path / "consensus.json")
    with open(dump, "w") as f:
        json.dump(doc, f)
    bare = str(tmp_path / "records.json")
    with open(bare, "w") as f:
        json.dump(records, f)
    first = records[0]
    letter = first["slot"]
    asks = [
        [dump], [dump, "--last", "3"], [dump, "--skips"], [bare, "--last", "2"],
        [dump, f"A{first['authority']}R{first['round']}"], [dump, letter],
        [dump, "A9R999999"], [dump, letter, "A9R999999"],
    ]
    codes = []
    for ask in asks:
        argv = ["--file", *ask]
        ours = (port.main(argv), capsys.readouterr().out)
        theirs = (jax_tool.main(argv), capsys.readouterr().out)
        assert ours == theirs, ask
        codes.append(ours[0])
    assert codes == [0, 0, 0, 0, 0, 0, 1, 1]


def test_needs_exactly_one_source(capsys):
    with pytest.raises(SystemExit) as exc:
        port.main(["--last", "3"])
    assert exc.value.code == 2
    assert "need exactly one of --url or --file" in capsys.readouterr().err


def test_slot_names_parse_as_the_jax_tools():
    for text in ("A3R42", "a0r1", "D42", "d7", "X", "A3", "R42", "3R42"):
        assert port.parse_slot(text) == jax_tool.parse_slot(text)
