"""The benchmark's own tests (run them with
``python -m pytest perfbench/tests``); they import nothing of the JAX
package.  A test that needs the card carries the ``card`` marker and skips
inside itself where there is none."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


def tiny_config(size: int = 4, forged_share: float = 0.25) -> dict:
    config = json.loads((ROOT / "perfbench" / "configs" / "committee-10.json").read_text())
    config["committee_size"] = size
    config["assumed"]["forged_share"] = forged_share
    return config


TINY_MIX = dict(kind="catchup", tx_per_block=4, backlog_rounds=6, frame_blocks=3,
                max_frame_bytes=1 << 24)


@pytest.fixture
def tiny_cell():
    from perfbench.run import Cell

    def make(**mix):
        return Cell("tiny-catchup", tiny_config(), {**TINY_MIX, **mix}, [], [])

    return make
