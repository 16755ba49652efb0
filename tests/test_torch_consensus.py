"""The port's commit rule, block manager, threshold clock and transaction
aggregator, against the JAX package's.

Every case builds the same DAG in both packages (the ``build_dag`` /
``build_dag_layer`` shapes of ``tests/helpers.py``) and compares, with no
tolerance: the ``LeaderStatus`` sequence (kind, slot, block digest) of the
base, multi-leader and pipelined committers over the canonical cases of
``tests/test_base_committer.py``, ``test_multi_committer.py`` and
``test_pipelined_committer.py`` and seeded random DAGs; the linearized
sub-DAGs of the committed leaders; the ``DecisionLedger``'s canonical bytes.
Then ``BlockManager`` and ``ThresholdClockAggregator`` on seeded arrival
orders, and ``TransactionAggregator``, ``shared_ranges`` and
``VoteRangeBuilder`` on the native ``va_*`` path and the Python one.
"""
import importlib
import random

import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Dag:
    """A store and writer over a WAL in ``tmp_dir`` (``tests/helpers.py``'s
    ``DagBlockWriter``), and the DAG builders, for either package."""

    def __init__(self, pkg, committee, tmp_dir):
        self.pkg = pkg
        self.types = _mod(pkg, "types")
        self.committee = committee
        bs = _mod(pkg, "block_store")
        w, r = _mod(pkg, "wal").walf(f"{tmp_dir}/{pkg}-dag")
        recovered, _ = bs.BlockStore.open(0, r, w, committee)
        self.block_store = recovered.block_store
        self.writer = bs.BlockWriter(w, self.block_store)
        self.wal = (w, r)

    def build(self, start, stop):
        """Fully connected rounds from ``start`` refs (or genesis) to ``stop``."""
        if start is None:
            genesis = [self.types.StatementBlock.new_genesis(a, self.committee.epoch)
                       for a in self.committee.authority_indexes()]
            for b in genesis:
                self.writer.insert_block(b)
            includes = [b.reference for b in genesis]
        else:
            includes = list(start)
        for round_ in range(includes[0].round + 1, stop + 1):
            blocks = [self.types.StatementBlock.build(a, round_, includes, (),
                                                      epoch=self.committee.epoch)
                      for a in self.committee.authority_indexes()]
            for b in blocks:
                self.writer.insert_block(b)
            includes = [b.reference for b in blocks]
        return includes

    def layer(self, connections):
        """One explicit layer: [(authority, parent refs)]."""
        refs = []
        for authority, parents in connections:
            block = self.types.StatementBlock.build(authority, parents[0].round + 1, parents, ())
            refs.append(block.reference)
            self.writer.insert_block(block)
        return refs

    def close(self):
        for x in self.wal:
            x.close()


# -- the DAG shapes -----------------------------------------------------------
# Each takes (dag, committee, wave) and builds; the committer is asked from
# AuthorityRound(0, 0) unless a shape returns a list of later calls.


def _direct(dag, c, w):
    dag.build(None, 5)


def _late_call(dag, c, w):
    dag.build(None, w * 11 - 1)


def _no_genesis_commit(dag, c, w):
    dag.build(None, 2 * w - 2)


def _no_leader(dag, c, w):
    refs = dag.build(None, w - 1)
    leader = c.elect_leader(w, 0)
    refs = dag.layer([(a, refs) for a in c.authority_indexes() if a != leader])
    dag.build(refs, 2 * w - 1)


def _direct_skip(dag, c, w):
    refs = dag.build(None, w)
    leader = c.elect_leader(w, 0)
    dag.build([r for r in refs if r.authority != leader], 2 * w - 1)


def _indirect_commit(dag, c, w):
    refs1 = dag.build(None, w)
    leader = c.elect_leader(w, 0)
    without = [r for r in refs1 if r.authority != leader]
    quorum, validity = c.quorum_threshold(), c.validity_threshold()
    auth = list(c.authority_indexes())
    with_votes = dag.layer([(a, refs1) for a in auth[:quorum]])
    without_votes = dag.layer([(a, without) for a in auth[quorum:]])
    refs3 = dag.layer([(a, with_votes) for a in auth[:validity]])
    mixed = (without_votes + with_votes)[:quorum]
    refs3 += dag.layer([(a, mixed) for a in auth[validity:]])
    dag.build(refs3, 3 * w - 1)


def _indirect_skip(dag, c, w):
    refs2 = dag.build(None, 2 * w)
    leader = c.elect_leader(2 * w, 0)
    without = [r for r in refs2 if r.authority != leader]
    validity = c.validity_threshold()
    auth = list(c.authority_indexes())
    refs = dag.layer([(a, refs2) for a in auth[:validity]])
    refs += dag.layer([(a, without) for a in auth[validity:]])
    dag.build(refs, 4 * w - 1)


def _undecided(dag, c, w):
    refs1 = dag.build(None, w)
    leader = c.elect_leader(w, 0)
    without = [r for r in refs1 if r.authority != leader]
    auth = list(c.authority_indexes())
    refs = dag.layer([(auth[0], refs1)] + [(a, without) for a in auth[1:c.quorum_threshold()]])
    dag.build(refs, 2 * w - 1)


def _partial_round(dag, c, w):
    refs = dag.build(None, w)
    leaders = {c.elect_leader(w, o) for o in range(2)}
    dag.layer([(a, refs) for a in c.authority_indexes()
               if a not in leaders or a == min(leaders)])


def _idempotence(dag, c, w):
    refs = dag.build(None, 5)
    return [("extend", lambda: dag.build(refs, 8))]


def _random(seed):
    def shape(dag, c, w):
        """Seeded layers: each authority (some missing) includes a random
        quorum-or-more subset of the previous layer."""
        rng = random.Random(seed)
        refs = dag.build(None, 1)
        auth = list(c.authority_indexes())
        for _ in range(4 * w + 2):
            present = [a for a in auth if rng.random() < 0.85] or auth[:1]
            conns = []
            for a in present:
                k = max(c.quorum_threshold(), rng.randrange(1, len(refs) + 1))
                parents = sorted(rng.sample(refs, min(k, len(refs))),
                                 key=lambda r: r.authority)
                conns.append((a, parents))
            new = dag.layer(conns)
            if len(new) >= c.quorum_threshold():
                refs = new
    return shape


SHAPES = {
    "direct": _direct, "late_call": _late_call, "no_genesis_commit": _no_genesis_commit,
    "no_leader": _no_leader, "direct_skip": _direct_skip, "indirect_commit": _indirect_commit,
    "indirect_skip": _indirect_skip, "undecided": _undecided, "partial_round": _partial_round,
    "idempotence": _idempotence, **{f"random{s}": _random(s) for s in range(4)},
}
COMMITTERS = {  # (number_of_leaders, pipeline)
    "base": (1, False), "multi2": (2, False), "multi3": (3, False), "pipelined": (1, True),
    "multi2_pipelined": (2, True),
}


def _commit_run(pkg, shape, leaders, pipeline, tmp_dir, size=4):
    """Build ``shape`` in ``pkg``, commit, linearize; plain values out."""
    consensus = _mod(pkg, "consensus")
    uc = _mod(pkg, "consensus.universal_committer")
    committee = _mod(pkg, "committee").Committee.new_test([1] * size)
    dag = _Dag(pkg, committee, tmp_dir)
    wave = consensus.DEFAULT_WAVE_LENGTH
    later = SHAPES[shape](dag, committee, wave) or []
    committer = (uc.UniversalCommitterBuilder(committee, dag.block_store)
                 .with_wave_length(wave).with_number_of_leaders(leaders)
                 .with_pipeline(pipeline).build())
    linearizer = _mod(pkg, "consensus.linearizer").Linearizer(dag.block_store)
    calls, last = [], consensus.AuthorityRound(0, 0)
    for step in [None] + later:
        if step is not None:
            step[1]()
        sequence = committer.try_commit(last)
        calls.append([(s.kind, s.authority, s.round,
                       s.block.reference.digest if s.block is not None else None)
                      for s in sequence])
        committed = [s.block for s in sequence if s.kind == consensus.LeaderStatus.COMMIT]
        calls.append([(d.height, d.anchor.digest, [b.reference.digest for b in d.blocks])
                      for d in linearizer.handle_commit(committed)])
        if sequence:
            last = consensus.AuthorityRound(sequence[-1].authority, sequence[-1].round)
    out = (calls, committer.ledger.ledger_bytes(), committer.ledger.undecided())
    dag.close()
    return out


def _in_sim(pkg, fn, *args):
    """Run ``fn`` on ``pkg``'s deterministic loop: the ledger's clock reads
    virtual time there."""
    async def main():
        return fn(*args)

    return _mod(pkg, "runtime.simulated").run_simulation(main())


@pytest.mark.parametrize("committer", sorted(COMMITTERS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_committers_decide_as_the_jax_package(tmp_path, shape, committer):
    leaders, pipeline = COMMITTERS[committer]
    port = _in_sim("mysticeti_tpu_torch", _commit_run, "mysticeti_tpu_torch", shape, leaders,
                   pipeline, str(tmp_path))
    jax = _in_sim("mysticeti_tpu", _commit_run, "mysticeti_tpu", shape, leaders, pipeline,
                  str(tmp_path))
    assert port == jax
    if (shape, committer) in (("late_call", "base"), ("indirect_skip", "base")):
        assert len(port[0][0]) >= 3  # the shape decides several leaders


def test_hundred_authority_committer(tmp_path):
    port = _in_sim("mysticeti_tpu_torch", _commit_run, "mysticeti_tpu_torch", "direct", 3, True,
                   str(tmp_path), 100)
    assert port == _in_sim("mysticeti_tpu", _commit_run, "mysticeti_tpu", "direct", 3, True,
                           str(tmp_path), 100)
    assert port[0][0]


# -- block manager and threshold clock --------------------------------------


def _random_blocks(pkg, seed, size=4, rounds=6):
    """A seeded DAG (each block includes a random quorum of the previous
    round) as blocks, genesis first."""
    types = _mod(pkg, "types")
    rng = random.Random(seed)
    quorum = 2 * size // 3 + 1
    layer = [types.StatementBlock.new_genesis(a) for a in range(size)]
    out = list(layer)
    for rnd in range(1, rounds + 1):
        refs = [b.reference for b in layer]
        layer = [types.StatementBlock.build(a, rnd, sorted(rng.sample(refs, rng.randrange(
            quorum, size + 1)), key=lambda r: r.authority), (types.Share(bytes([a, rnd])),))
            for a in range(size)]
        out += layer
    return out


def _manager_run(pkg, seed, tmp_dir):
    committee = _mod(pkg, "committee").Committee.new_test([1] * 4)
    dag = _Dag(pkg, committee, tmp_dir)
    manager = _mod(pkg, "block_manager").BlockManager(dag.block_store, 4)
    blocks = _random_blocks(pkg, seed)
    order = list(range(len(blocks)))
    random.Random(seed + 100).shuffle(order)
    steps = []
    i = 0
    while i < len(order):
        batch = [blocks[j] for j in order[i:i + 1 + (i % 3)]]
        i += len(batch)
        processed, missing = manager.add_blocks(batch, dag.writer)
        steps.append(([(pos, b.reference.digest) for pos, b in processed],
                      sorted(r.digest for r in missing),
                      [sorted(r.digest for r in s) for s in manager.missing_blocks()]))
    assert not manager.blocks_pending and not manager.block_references_waiting
    dag.close()
    return steps


@pytest.mark.parametrize("seed", range(4))
def test_block_manager_as_the_jax_package(tmp_path, seed):
    assert _manager_run("mysticeti_tpu_torch", seed, str(tmp_path)) == _manager_run(
        "mysticeti_tpu", seed, str(tmp_path))


@pytest.mark.parametrize("seed", range(3))
def test_threshold_clock_aggregator_as_the_jax_package(seed):
    rounds = {}
    for pkg in PACKAGES:
        types = _mod(pkg, "types")
        tc = _mod(pkg, "threshold_clock")
        committee = _mod(pkg, "committee").Committee.new_test([1, 2, 3, 1, 1])
        clock = tc.ThresholdClockAggregator(0)
        rng = random.Random(seed)
        seen = []
        for _ in range(300):
            ref = types.BlockReference(rng.randrange(5), rng.randrange(max(0, clock.get_round() - 1),
                                                                       clock.get_round() + 2),
                                       bytes(32))
            clock.add_block(ref, committee)
            seen.append(clock.get_round())
        valid = [tc.threshold_clock_valid_non_genesis(b, committee)
                 for b in _random_blocks(pkg, seed, size=5) if b.round() > 0]
        rounds[pkg] = (seen, valid)
    assert rounds["mysticeti_tpu_torch"] == rounds["mysticeti_tpu"]
    assert rounds["mysticeti_tpu"][0][-1] > 10


# -- transaction aggregator, shared ranges, vote ranges ---------------------


def _aggregator_blocks(pkg, seed, size=4, rounds=8):
    """Seeded blocks whose statements interleave shares with votes and vote
    ranges over earlier blocks' shares (some partial, some repeated by
    other authors)."""
    types = _mod(pkg, "types")
    rng = random.Random(seed)
    blocks, shared = [], []
    genesis = [types.StatementBlock.new_genesis(a).reference for a in range(size)]
    for rnd in range(1, rounds + 1):
        for a in range(size):
            statements = []
            for i in range(rng.randrange(1, 12)):
                kind = rng.random()
                if kind < 0.5 or not shared:
                    statements.append(types.Share(bytes([a, rnd, i])))
                elif kind < 0.8:
                    ref, s, e = rng.choice(shared)
                    lo = rng.randrange(s, e)
                    hi = rng.randrange(lo + 1, e + 1)
                    statements.append(types.VoteRange(types.TransactionLocatorRange(ref, lo, hi)))
                else:
                    ref, s, e = rng.choice(shared)
                    statements.append(types.Vote(types.TransactionLocator(ref, rng.randrange(s, e)),
                                                 True))
            block = types.StatementBlock.build(a, rnd, genesis, statements)
            for s, e in (types.StatementBlock.from_bytes(block.to_bytes())._share_runs or
                         [(r.offset_start_inclusive, r.offset_end_exclusive)
                          for r in _mod(pkg, "committee").shared_ranges(block)]):
                shared.append((block.reference, s, e))
            blocks.append(block)
    return blocks


def _aggregator_run(pkg, seed, native, monkeypatch):
    committee_mod = _mod(pkg, "committee")
    native_mod = _mod(pkg, "native")
    if not native:
        monkeypatch.setattr(native_mod, "native", None)
    elif native_mod.native is None:
        pytest.fail(f"{pkg}'s native extension did not build")
    types = _mod(pkg, "types")
    committee = committee_mod.Committee.new_test([1] * 4)
    agg = committee_mod.TransactionAggregator(committee_mod.QUORUM)
    assert (agg._nat is not None) == native
    out = []
    blocks = _aggregator_blocks(pkg, seed)
    # Decoded copies carry the native decoder's share spans; built ones walk.
    decoded = [types.StatementBlock.from_bytes(b.to_bytes()) for b in blocks]
    for i, block in enumerate(decoded):
        response = []
        processed = agg.process_block(block, response, committee)
        out.append(([(r.block.digest, r.offset_start_inclusive, r.offset_end_exclusive)
                     for r in processed], len(response), len(agg)))
        if i % 7 == 0:
            out.append(agg.state())
    out.append(sorted((loc.block.digest, loc.offset)
                      for b in decoded for loc, _ in b.shared_transactions()
                      if agg.is_processed(loc)))
    restored = committee_mod.TransactionAggregator(committee_mod.QUORUM)
    restored.with_state(agg.state())
    out.append(restored.state() == agg.state())
    ranges = [[(r.block.digest, r.offset_start_inclusive, r.offset_end_exclusive)
               for r in committee_mod.shared_ranges(b)] for b in blocks + decoded]
    builder = committee_mod.VoteRangeBuilder()
    runs = [builder.add(o) for o in (0, 1, 2, 5, 6, 9, 10, 11, 12, 20)] + [builder.finish()]
    return out, ranges, runs


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", range(3))
def test_transaction_aggregator_as_the_jax_package(monkeypatch, seed, native):
    port = _aggregator_run("mysticeti_tpu_torch", seed, native, monkeypatch)
    jax = _aggregator_run("mysticeti_tpu", seed, native, monkeypatch)
    assert port == jax
    out, ranges, _ = port
    assert any(step[0] for step in out if isinstance(step, tuple))  # something certified
    assert ranges[: len(ranges) // 2] == ranges[len(ranges) // 2:]  # built == decoded
