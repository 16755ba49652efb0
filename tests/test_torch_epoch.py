"""Epochs on the port: the finalization oracle, the epoch-change spec, and
fleets that cross reconfiguration boundaries, against the JAX package.

* The counterparts of ``tests/test_epoch_sim.py``'s four tests, one a seed
  (17, 19, 23, 29): ``tests/test_torch_net_sync.py``'s
  ``test_epoch_close_as_the_jax_package`` already holds the closed epochs
  of seeds 17 and 19 (every node closes, equal sequences, equal to the JAX
  package's), so here the port's ``FinalizationInterpreter`` runs over each
  closed epoch's stores: every finalized transaction has a certifying
  block in the last committed leader's history, the oracle's findings
  equal the JAX package's over the JAX package's run, and an early leader
  leaves some uncovered (the perturbation test).
* The counterparts of ``tests/test_epoch_spec.py``'s six tests, reading the
  port's ``EpochManager``, ``Core`` and ``NetworkSyncer`` against the same
  "Epoch change" section of ``docs/commit-rule.md``.
* Same-seed parity of whole fleets with the reconfiguration and execution
  planes on, through ``tests/test_torch_storage_lifecycle.py``'s
  ``_run_fleet`` on both packages: the churn shape of
  ``tests/test_reconfig.py`` (a reweight, a remove and the removed node
  stopped, a crash and a checkpoint boot after both boundaries) with the
  execution workload, and a zero-stake authority ADDed while absent that
  boots from an empty WAL and adopts a snapshot whose epoch chain and
  execution state carry the boundary.
* ``chip_smoke.py``'s ``epoch`` phase in small through the plain kernels.
"""
import asyncio
import importlib
import inspect
import os
import re

import pytest

import chip_smoke
import test_epoch_sim
from test_torch_core import _in_sim
from test_torch_net_sync import _run_epoch_nodes
from test_torch_storage_lifecycle import _run_fleet

PORT, JAX = "mysticeti_tpu_torch", "mysticeti_tpu"
PACKAGES = (JAX, PORT)

pytestmark = pytest.mark.reconfig

DOC = open(os.path.join(os.path.dirname(__file__), "..", "docs", "commit-rule.md")).read()
EPOCH_SECTION = DOC.split("## Epoch change", 1)[1]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _ref(r):
    return (r.authority, r.round, r.digest)


# -- the finalization oracle over closed epochs --------------------------------


def _closed_epoch(pkg, tmp_path, seed):
    """``tests/test_epoch_sim.py``'s closed epoch on ``pkg`` under ``seed``."""
    d = tmp_path / pkg
    d.mkdir()
    if pkg == PORT:
        main = _run_epoch_nodes(4, str(d))
    else:
        main = test_epoch_sim._run_epoch_nodes(4, str(d))
    return _mod(pkg, "runtime.simulated").run_simulation(main, seed=seed)


def _oracle(pkg, node, leader_index=-1):
    """``pkg``'s ``FinalizationInterpreter`` over ``node``'s store: each
    finalized transaction with its certifying blocks, and whether one of
    them is in the history of the committed leader at ``leader_index``, in
    the order the oracle gives them."""
    store = node.core.block_store
    leader = store.get_block(list(node.syncer.commit_observer.committed_leaders)[leader_index])
    assert leader is not None
    finalized = _mod(pkg, "finalization_interpreter").FinalizationInterpreter(
        store, node.core.committee).finalized_tx_certifying_blocks()
    out = []
    for tx, certifying in finalized:
        covered = any(store.get_block(r) is not None and store.linked(leader, store.get_block(r))
                      for r in certifying)
        out.append(((*_ref(tx.block), tx.offset), sorted(_ref(r) for r in certifying), covered))
    return out


@pytest.mark.parametrize("seed", [17, 19, 23])
def test_finalization_safety_as_the_jax_package(tmp_path, seed):
    """Every finalized transaction has a certifying block linked from the
    last committed leader, on every node, and the port's oracle over the
    port's stores finds what the JAX package's finds over its own, in the
    same order."""
    found = {pkg: [_oracle(pkg, node) for node in _closed_epoch(pkg, tmp_path, seed)]
             for pkg in PACKAGES}
    assert found[PORT] == found[JAX]
    for per_node in found[PORT]:
        assert per_node, "the oracle found no finalized transaction"
        assert all(covered for _tx, _certifying, covered in per_node)


def test_finalization_safety_detects_perturbation(tmp_path):
    """Pointed at the first committed leader, the oracle leaves finalized
    transactions uncovered, in both packages alike: the check discriminates."""
    found = {pkg: _oracle(pkg, _closed_epoch(pkg, tmp_path, 29)[0], leader_index=0)
             for pkg in PACKAGES}
    assert found[PORT] == found[JAX]
    assert sum(not covered for _tx, _certifying, covered in found[PORT]) > 0


# -- the epoch-change spec (docs/commit-rule.md) -----------------------------------


def test_doc_states_match_implementation():
    from mysticeti_tpu_torch.epoch_close import BEGIN_CHANGE, OPEN, SAFE_TO_CLOSE, EpochManager

    assert all(state in EPOCH_SECTION for state in ("Open", "BeginChange", "SafeToClose"))
    assert (OPEN, BEGIN_CHANGE, SAFE_TO_CLOSE) == (0, 1, 2)
    m = EpochManager()
    assert m.status == OPEN and not m.changing() and not m.closed()
    m.epoch_change_begun()
    assert m.status == BEGIN_CHANGE and m.changing() and not m.closed()


def test_claim_1_trigger_is_committed_leader_round():
    from mysticeti_tpu_torch.core import Core

    src = inspect.getsource(Core.try_commit)
    assert "rounds_in_epoch" in src and "epoch_change_begun" in src


def _proposals(pkg, tmp_dir):
    """Core 0 proposes with no change begun, core 1 mid-change: each
    proposal's marker, whether it shares a transaction, and its bytes."""
    from test_torch_core import _cores

    _committee, cores = _cores(pkg, tmp_dir)
    genesis = [_mod(pkg, "types").StatementBlock.new_genesis(a) for a in range(4)]
    out = []
    for index, changing in ((0, False), (1, True)):
        core = cores[index]
        core.add_blocks([b for a, b in enumerate(genesis) if a != index])
        if changing:
            core.epoch_manager.epoch_change_begun()
        block = core.try_new_block()
        shares = any(isinstance(s, _mod(pkg, "types").Share) for s in block.statements)
        out.append((block.epoch_marker, shares, block.to_bytes()))
    for core in cores:
        core.wal_writer.close()
    return out


def test_claim_2_changing_proposals_carry_marker_and_no_payload(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _in_sim(PORT, _proposals, PORT, str(tmp_path / "port"))
    assert port == _in_sim(JAX, _proposals, JAX, str(tmp_path / "jax"))
    (marker0, shares0, _), (marker1, shares1, _) = port
    assert (marker0, shares0) == (0, True)
    assert (marker1, shares1) == (1, False)


def test_claim_3_safe_to_close_needs_quorum_of_distinct_marker_authors():
    def case(pkg):
        Committee = _mod(pkg, "committee").Committee
        StatementBlock = _mod(pkg, "types").StatementBlock
        committee = Committee.new_test([1, 1, 1, 1])
        signers = Committee.benchmark_signers(4)

        def marker_block(author, round_):
            return StatementBlock.build(author, round_, [], (), epoch_marker=1,
                                        signer=signers[author])

        m = _mod(pkg, "epoch_close").EpochManager()
        m.epoch_change_begun()
        closed = []
        for block in (marker_block(0, 1), marker_block(0, 2), marker_block(1, 1),
                      StatementBlock.build(2, 1, [], (), signer=signers[2]), marker_block(2, 2)):
            m.observe_committed_block(block, committee)
            closed.append(m.closed())
        assert m.closing_time() > 0
        return closed

    got = case(PORT)
    assert got == case(JAX) == [False, False, False, False, True]


def test_claim_4_grace_period_wiring():
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.net_sync import NetworkSyncer

    assert hasattr(Parameters(), "shutdown_grace_period_s")
    src = inspect.getsource(NetworkSyncer._epoch_watch_task)
    assert "shutdown_grace_period_s" in src and "epoch_closed" in src and "stop" in src


def test_doc_quorum_phrase_matches_code_threshold():
    from mysticeti_tpu_torch.committee import QUORUM
    from mysticeti_tpu_torch.epoch_close import EpochManager

    assert re.search(r"quorum \(2f\+1\)", EPOCH_SECTION)
    assert EpochManager().change_aggregator.kind is QUORUM


# -- fleets across reconfiguration boundaries, both packages ----------------------


def _exec_batches(pkg, fleet, interval_s=0.5):
    """``scenarios``' execution workload on ``fleet``: every
    ``interval_s`` each live node plants a CREATE of a fresh account, two
    TRANSFERs out of it in nonce order and one overdraft."""
    ex = _mod(pkg, "execution")

    async def batches():
        batch = 0
        while True:
            await asyncio.sleep(interval_s)
            batch += 1
            for a, node in enumerate(fleet.nodes):
                if node is None:
                    continue
                account, sink = f"acct-{a}-{batch}".encode(), f"sink-{a}".encode()
                for tx in (ex.ExecTx(ex.OP_CREATE, account, amount=1000),
                           ex.ExecTx(ex.OP_TRANSFER, account, nonce=1, amount=300, dest=sink),
                           ex.ExecTx(ex.OP_TRANSFER, account, nonce=2, amount=300, dest=b"treasury"),
                           ex.ExecTx(ex.OP_TRANSFER, account, nonce=3, amount=500, dest=sink)):
                    fleet.inject(a, tx.to_bytes())

    return batches()


def _churn_workload(pkg, changes, retire=(), join=()):
    """A ``_run_fleet`` workload: ``changes`` (at_s, kind, authority, stake)
    planted through node 0, nodes retired or joined at their times, and the
    execution workload throughout."""
    r = _mod(pkg, "reconfig")

    async def workload(fleet):
        loop = asyncio.get_running_loop()
        events = ([(at, "change", (kind, a, stake)) for at, kind, a, stake in changes]
                  + [(at, "retire", a) for at, a in retire] + [(at, "join", a) for at, a in join])

        async def schedule():
            for at, what, arg in sorted(events, key=lambda e: e[0]):
                await asyncio.sleep(at - loop.time())
                if what == "change":
                    fleet.inject(0, r.CommitteeChange(getattr(r, arg[0]), *arg[1:]).to_bytes())
                elif what == "retire":
                    await fleet.retire(arg)
                else:
                    await fleet.join(arg)

        await asyncio.gather(schedule(), _exec_batches(pkg, fleet))

    return workload


def _fleet_reading(fleet, n):
    """What the parity tests compare: committed sequences, each node's last
    epoch, epoch chain bytes and execution state bytes, every root folded
    by height, and the storage readings of snapshot adoption."""
    cores = [None if node is None else node.core for node in fleet.nodes]
    return {
        "sequences": [[_ref(r) for r in fleet.checker.sequence(a)] for a in range(n)],
        "epochs": [None if c is None else c.committee.epoch for c in cores],
        "chains": [None if c is None else c.reconfig.chain.to_bytes() for c in cores],
        "exec": [None if c is None else c.execution.to_bytes() for c in cores],
        "roots": fleet.checker.roots,
        "adopted": [None if c is None else c.storage.snapshots_adopted for c in cores],
    }


def _parameters(pkg, **storage):
    config = _mod(pkg, "config")
    return config.Parameters(leader_timeout_s=0.3, reconfig=True, execution=True,
                             leader_liveness_horizon_rounds=4,
                             storage=config.StorageParameters(**storage))


CHURN = dict(n=6, duration_s=11.0, seed=18, crashes=[(3, 8.0, 1.0, 0)],
             changes=[(2.0, "CHANGE_REWEIGHT", 1, 3), (5.0, "CHANGE_REMOVE", 4, 0)],
             retire=[(7.0, 4)])


def _churn_run(pkg, wal_dir):
    n = CHURN["n"]
    fleet, crashes = _run_fleet(
        pkg, n, CHURN["duration_s"], wal_dir,
        _parameters(pkg, segment_bytes=16 * 1024, checkpoint_interval=5),
        crashes=CHURN["crashes"], seed=CHURN["seed"],
        committee=_mod(pkg, "committee").Committee.new_for_benchmarks(n),
        workload=_churn_workload(pkg, CHURN["changes"], retire=CHURN["retire"]))
    reading = _fleet_reading(fleet, n)
    rebooted = fleet.nodes[3].core
    reading["reboot"] = (fleet.nodes[3].core.storage.recovered_checkpoint_height,
                         rebooted.execution.last_height, crashes[0]["committed_height"])
    return reading


def test_churn_fleet_crosses_two_boundaries_as_the_jax_package(tmp_path):
    """A reweight, a remove and the removed node stopped, then a crash and
    a checkpoint boot: every live node ends in epoch 2 with the same epoch
    chain, the removed node saw at least epoch 1, the execution roots agree
    at every height, and the port gives the JAX package's sequences, epoch
    chains, execution state and roots for the same seed."""
    got = {pkg: _churn_run(pkg, str(tmp_path / pkg)) for pkg in PACKAGES}
    port = got[PORT]
    assert port == got[JAX]
    live = [a for a in range(CHURN["n"]) if a != 4]
    assert [port["epochs"][a] for a in live] == [2] * len(live)
    assert port["epochs"][4] is None and max(port["roots"][4]) > 0
    chain = port["chains"][0]
    assert all(port["chains"][a] == chain for a in live)
    assert _mod(PORT, "reconfig").EpochChain.from_bytes(chain).epoch == 2
    assert all(len(port["sequences"][a]) > 0 for a in live)
    checkpoint_height, exec_height, crashed_at = port["reboot"]
    assert checkpoint_height > 0 and exec_height > crashed_at
    shared = set(port["roots"][3]) & set(port["roots"][0])
    assert len(shared) > 10


JOIN = dict(n=6, duration_s=14.0, seed=7, absent={5}, changes=[(3.0, "CHANGE_ADD", 5, 1)],
            join=[(7.0, 5)])


def _join_run(pkg, wal_dir):
    n = JOIN["n"]
    fleet, _ = _run_fleet(
        pkg, n, JOIN["duration_s"], wal_dir,
        _parameters(pkg, segment_bytes=16 * 1024, checkpoint_interval=5, gc_depth=30,
                    snapshot_catchup=True, catchup_threshold_commits=10),
        seed=JOIN["seed"], absent=JOIN["absent"],
        committee=_mod(pkg, "committee").Committee.new_for_benchmarks(n, stakes=[1] * 5 + [0]),
        workload=_churn_workload(pkg, JOIN["changes"], join=JOIN["join"]))
    reading = _fleet_reading(fleet, n)
    reading["heights"] = [fleet.committed_height(a) for a in range(n)]
    return reading


def test_zero_stake_joiner_adopts_the_boundary_as_the_jax_package(tmp_path):
    """Authority 5, registered at stake 0, is ADDed while absent and boots
    from an empty WAL far behind: it adopts a snapshot whose epoch chain
    carries the ADD boundary and whose execution state carries the fleet's
    root, lands on epoch 1 with the fleet's committee, commits a window of
    the fleet's sequence and folds the fleet's roots; the port gives the
    JAX package's sequences, chains, state and roots for the same seed."""
    got = {pkg: _join_run(pkg, str(tmp_path / pkg)) for pkg in PACKAGES}
    port = got[PORT]
    assert port == got[JAX]
    n = JOIN["n"]
    assert port["epochs"] == [1] * n
    assert all(chain == port["chains"][0] for chain in port["chains"])
    assert port["adopted"][5] == 1
    joiner, height = port["sequences"][5], port["heights"][5]
    reference = max(range(5), key=lambda a: port["heights"][a])
    assert joiner and len(joiner) < height
    assert joiner == port["sequences"][reference][height - len(joiner):height]
    roots5, roots0 = port["roots"][5], port["roots"][0]
    assert roots5 and all(roots0[h] == roots5[h] for h in roots5 if h in roots0)
    assert min(roots5) > 1  # the folds start above the adopted baseline


# -- chip_smoke.py's epoch phase in small ------------------------------------------

# epoch-10's shape at n = 4: node 1 reweighted to 3 at 1 s, node 3 removed at
# 2.5 s and stopped at 7 s, node 2 down from 8.5 s to 9.5 s; a batch a node
# every virtual second; the oracle over the first 10 rounds.
EPOCH_SMALL = dict(
    chip_smoke.EPOCH_10, n=4, virtual_s=12.0, fault_one_in=6,
    changes=((1.0, 0, "reweight", 1, 3), (2.5, 0, "remove", 3, 0)), retire=((7.0, 3),),
    crashes=((2, 8.5, 1.0, 0),), retiree=3, exec_interval_s=1.0, oracle_rounds=10,
    storage=dict(segment_bytes=4096, checkpoint_interval=2))


def test_epoch_phase_in_small_through_the_plain_kernels(monkeypatch):
    """``chip_smoke.epoch_run`` of ``EPOCH_SMALL`` with every incarnation's
    ``_make_verifier("cuda-only", device="cpu")`` (the kernels' plain
    versions, made and warmed before the run) and with the ``cpu`` kind,
    each collector with a 300 ms window (a plain dispatch costs ~0.8 s of
    CPU: ~100 flushes, where the phase's 5 ms window would take thousands):
    the card's checks of the epoch phase hold (epochs and boundaries fleet
    wide, sequences and roots agreeing and equal across the runs, every
    planted overdraft rejected, the checkpoint boot in epoch 2 on the
    fleet's root, forged copies rejected, the finalization oracle, the
    verdicts accounted for, one committee note a boundary crossed), and the
    two runs count the same."""
    monkeypatch.setenv("MYSTICETI_VERIFY_WINDOW_MS", "300")
    plain = chip_smoke.epoch_run("cuda-only", EPOCH_SMALL, device="cpu")
    cpu = chip_smoke.epoch_run("cpu", EPOCH_SMALL)
    reading = chip_smoke.epoch_checks(plain, cpu, EPOCH_SMALL)
    assert reading["counts"] == chip_smoke.epoch_counts(cpu)
    assert reading["epochs"] == [2] * 4 and reading["reboot"]["boot_epoch"] == 2
    chip_smoke.card_checks(plain)
    assert plain["on_card_twice"] == 0
    for inc in plain["incarnations"]:
        assert inc["notes"] == inc["boundaries_crossed"]
    assert sum(inc["notes"] for inc in plain["incarnations"]) > 0
