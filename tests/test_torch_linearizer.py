"""The port's linearizer held to ``tests/test_linearizer.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``, with ``helpers`` on the port too):
sub-DAG expansion and dedup, the commit data round trip and recovery.
Beyond it, over the same seeded DAGs (each authority linking a random
quorum of the layer below), the port's committed sequence and the
sub-DAGs its linearizer cuts from it, handed over in seeded chunks and
across a recovery, must equal the JAX package's: heights, anchors and
every block's reference in order.
"""
import importlib
import random
import sys

import pytest

from torch_reference import suite_on_port

globals().update(suite_on_port("test_linearizer.py"))

HELPERS = {"mysticeti_tpu": "helpers", "mysticeti_tpu_torch": "torch_reference_helpers"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def linearizer_run(pkg, seed, tmp_dir):
    helpers = sys.modules[HELPERS[pkg]] if pkg != "mysticeti_tpu" else importlib.import_module(
        "helpers")
    consensus = _mod(pkg, "consensus")
    types = _mod(pkg, "types")
    rng = random.Random(seed)
    size = rng.choice((4, 5, 7))
    committee = _mod(pkg, "committee").Committee.new_test([rng.choice((1, 2, 3))
                                                            for _ in range(size)])
    writer = helpers.DagBlockWriter(committee, tmp_dir)
    genesis = [types.StatementBlock.new_genesis(a) for a in range(size)]
    writer.add_blocks(genesis)
    layer = [b.reference for b in genesis]
    for _ in range(rng.randrange(8, 16)):
        links = []
        for a in range(size):
            parents = sorted(rng.sample(layer, k=max(1, len(layer) - rng.randrange(2))),
                             key=lambda r: (r.authority, r.digest))
            links.append((a, parents))
        layer = helpers.build_dag_layer(links, writer)
    committer = _mod(pkg, "consensus.universal_committer").UniversalCommitterBuilder(
        committee, writer.block_store).build()
    sequence = committer.try_commit(consensus.AuthorityRound(0, 0))
    leaders = [s.block for s in sequence if s.block is not None]
    linearizer_mod = _mod(pkg, "consensus.linearizer")
    first = linearizer_mod.Linearizer(writer.block_store)
    out = [[(s.block is not None, str(s)) for s in sequence]]
    cut = rng.randrange(len(leaders) + 1)
    head = first.handle_commit(leaders[:cut])
    recovered = _mod(pkg, "state").CommitObserverRecoveredState(sub_dags=[
        _mod(pkg, "block_store").CommitData(sd.anchor, [b.reference for b in sd.blocks],
                                            sd.height) for sd in head])
    second = linearizer_mod.Linearizer(writer.block_store)
    second.recover_state(recovered)
    for linearizer in (first, second):
        sub_dags = list(head) if linearizer is first else []
        i = cut
        while i < len(leaders):
            step = rng.randrange(1, 4)
            sub_dags += linearizer.handle_commit(leaders[i:i + step])
            i += step
        out.append([(sd.height, _ref(sd.anchor), [_ref(b.reference) for b in sd.blocks])
                    for sd in sub_dags])
    return out, len(leaders)


def _ref(r):
    return r.authority, r.round, r.digest


@pytest.mark.parametrize("seed", range(4))
def test_sub_dags_as_the_jax_package(tmp_path, seed):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port, leaders = linearizer_run("mysticeti_tpu_torch", seed, str(tmp_path / "port"))
    assert port == linearizer_run("mysticeti_tpu", seed, str(tmp_path / "jax"))[0]
    assert leaders >= 2
    # Recovery mid-sequence cuts the same tail as the uninterrupted run.
    whole, resumed = port[1], port[2]
    assert whole[len(whole) - len(resumed):] == resumed
