"""The port's committee held to ``tests/test_committee.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): thresholds, leader election,
``StakeAggregator``, ``TransactionAggregator`` (native core and Python
path), shared ranges and vote ranges.  The aggregator's seeded traces are
also held to the JAX package's by
``tests/test_torch_consensus.py::test_transaction_aggregator_as_the_jax_package``.

Beyond the suite, on the same seeded committees and inputs, the port's
thresholds, elections (round robin and stake based, every offset) and
``StakeAggregator`` results and encodings must equal the JAX package's.
"""
import random

import pytest

from mysticeti_tpu import committee as JC
from mysticeti_tpu import serde as JS
from mysticeti_tpu_torch import committee as PC
from mysticeti_tpu_torch import serde as PS
from torch_reference import suite_on_port

globals().update(suite_on_port("test_committee.py"))

SIDES = {"jax": (JC, JS), "port": (PC, PS)}


def _stakes(seed):
    rng = random.Random(seed)
    size = rng.randrange(1, 12)
    stakes = [rng.choice((0, 1, 1, 2, 3, 100, 10_000)) for _ in range(size)]
    if not any(stakes):
        stakes[0] = 1
    return stakes


def committee_trace(side, seed):
    cm, _ = SIDES[side]
    c = cm.Committee.new_test(_stakes(seed))
    total = c.total_stake
    thresholds = [c.quorum_threshold(), c.validity_threshold(), total,
                  [(a, c.is_quorum(a), c.is_valid(a)) for a in range(total + 2)
                   if a < 64 or a % 97 == 0],
                  [(a, c.is_active(a), c.known_authority(a)) for a in range(len(c) + 1)]]
    elections = [[c.elect_leader(r, off) for off in range(3)] for r in range(40)]
    stake_based = [[c.elect_leader_stake_based(r, off) for off in range(c.active_count())]
                   for r in range(60)]
    return thresholds, elections, stake_based


@pytest.mark.parametrize("seed", range(8))
def test_thresholds_and_elections_as_the_jax_package(seed):
    port = committee_trace("port", seed)
    assert port == committee_trace("jax", seed)
    stake_based = port[2]
    # Genesis elects authority 0; past it every offset of a round elects a
    # distinct active authority.
    assert set(stake_based[0]) == {0}
    assert all(len(set(row)) == len(row) for row in stake_based[1:])


def aggregator_trace(side, seed):
    cm, serde = SIDES[side]
    rng = random.Random(seed)
    c = cm.Committee.new_test(_stakes(seed))
    out = []
    for kind in (cm.QUORUM, cm.VALIDITY):
        agg = cm.StakeAggregator(kind)
        for _ in range(3 * len(c)):
            voter = rng.randrange(len(c))
            out.append((voter, agg.add(voter, c), agg.stake, agg.is_reached(c)))
        w = serde.Writer()
        agg.encode(w)
        raw = w.finish()
        back = cm.StakeAggregator.decode(serde.Reader(raw))
        out.append((raw, back.kind, back.stake, sorted(back.voters()),
                    sorted(agg.copy().voters())))
        agg.clear()
        out.append((agg.stake, sorted(agg.voters())))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_stake_aggregator_as_the_jax_package(seed):
    assert aggregator_trace("port", seed) == aggregator_trace("jax", seed)
