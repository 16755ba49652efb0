"""The port's ``Core``, against the JAX package's.

The cases of ``tests/test_core.py`` (simple exchange, randomized exchange,
recovery) run on both packages, each on its own deterministic loop, so block
timestamps are virtual.  The two must give byte-identical blocks, author by
author and round by round, and the same committed leaders.  A port ``Core``
recovers from WALs that the JAX package wrote, and the reverse.  The default
``Parameters`` never import the reconfiguration or execution planes, which
the port does not have yet.
"""
import importlib
import random
import shutil
import subprocess
import sys

import pytest

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")
PORT, JAX = "mysticeti_tpu_torch", "mysticeti_tpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _open_core(pkg, committee, authority, tmp_dir, signer, parameters=None):
    """``tests/helpers.py``'s ``open_core`` over either package."""
    wal_writer, wal_reader = _mod(pkg, "wal").walf(f"{tmp_dir}/wal-{authority}")
    recovered, _ = _mod(pkg, "block_store").BlockStore.open(
        authority, wal_reader, wal_writer, committee)
    handler = _mod(pkg, "block_handler").TestBlockHandler(
        last_transaction=authority * 1_000_000, committee=committee, authority=authority)
    core = _mod(pkg, "core")
    return core.Core(
        block_handler=handler, authority=authority, committee=committee,
        parameters=parameters or _mod(pkg, "config").Parameters(), recovered=recovered,
        wal_writer=wal_writer, options=core.CoreOptions.test(), signer=signer)


def _cores(pkg, tmp_dir, n=4):
    Committee = _mod(pkg, "committee").Committee
    committee = Committee.new_test([1] * n)
    signers = Committee.benchmark_signers(n)
    return committee, [_open_core(pkg, committee, a, tmp_dir, signers[a]) for a in range(n)]


def _in_sim(pkg, fn, *args):
    """``fn`` on ``pkg``'s deterministic loop: ``runtime.timestamp_utc`` is
    virtual there, so blocks are reproducible."""
    async def main():
        return fn(*args)

    return _mod(pkg, "runtime.simulated").run_simulation(main())


def _decode(pkg, raws):
    return [_mod(pkg, "types").StatementBlock.from_bytes(r) for r in raws]


def _commits(core):
    return [b.to_bytes() for b in core.try_commit()]


def _simple_exchange(pkg, tmp_dir):
    _, cores = _cores(pkg, tmp_dir)
    log, proposed, blocks = [], [], []
    for core in cores:
        core.run_block_handler([])
        block = core.try_new_block()
        assert block is not None and block.round() == 1
        proposed.extend(core.block_handler.proposed)
        core.block_handler.proposed.clear()
        blocks.append(block)
    assert len(proposed) == 4
    log.append([b.to_bytes() for b in blocks])
    blocks_r2 = []
    for core in cores:
        core.add_blocks(blocks[:1])
        assert core.try_new_block() is None  # no quorum yet
        core.add_blocks(blocks[1:])
        block = core.try_new_block()
        assert block is not None and block.round() == 2
        blocks_r2.append(block)
        log.append(_commits(core))
    log.append([b.to_bytes() for b in blocks_r2])
    for core in cores:
        core.add_blocks(blocks_r2)
        block = core.try_new_block()
        assert block is not None and block.round() == 3
        log.append(block.to_bytes())
        log.append(_commits(core))
        assert all(core.block_handler.is_certified(tx) for tx in proposed)
    for core in cores:
        core.wal_writer.close()
    return log


def test_core_simple_exchange(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = _in_sim(PORT, _simple_exchange, PORT, str(tmp_path / "p"))
    assert port == _in_sim(JAX, _simple_exchange, JAX, str(tmp_path / "j"))


def _randomized_exchange(pkg, tmp_dir, seed):
    rng = random.Random(seed)
    committee, cores = _cores(pkg, tmp_dir)
    valid = _mod(pkg, "threshold_clock").threshold_clock_valid_non_genesis
    proposed, pending, log = [], [[] for _ in range(4)], []

    def push_all(except_authority, block):
        log.append((except_authority, block.to_bytes()))
        for i, q in enumerate(pending):
            if i != except_authority:
                q.append(block)

    for core in cores:
        core.run_block_handler([])
        block = core.try_new_block()
        assert block is not None and block.round() == 1
        assert valid(block, committee)
        proposed.extend(core.block_handler.proposed)
        core.block_handler.proposed.clear()
        push_all(core.authority, block)
    for i in range(1000):
        authority = rng.randrange(4)
        core = cores[authority]
        this_pending = pending[authority]
        count = rng.randint(1, 3)
        blocks = []
        for _ in range(count):
            if not this_pending:
                break
            blocks.append(this_pending.pop(rng.randrange(len(this_pending))))
        if not blocks:
            continue
        core.add_blocks(blocks)
        block = core.try_new_block()
        if block is None:
            continue
        assert valid(block, committee)
        push_all(core.authority, block)
        log.append(("commits", authority, _commits(core)))
        if i < 20:
            proposed.extend(core.block_handler.proposed)
            core.block_handler.proposed.clear()
        elif all(c.block_handler.is_certified(tx) for tx in proposed for c in cores):
            return log, i  # all certified everywhere
    pytest.fail(f"{pkg} seed {seed}: not all transactions certified")


@pytest.mark.parametrize("seed", range(20))
def test_randomized_simple_exchange(tmp_path, seed):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = _in_sim(PORT, _randomized_exchange, PORT, str(tmp_path / "p"), seed)
    assert port == _in_sim(JAX, _randomized_exchange, JAX, str(tmp_path / "j"), seed)


# -- recovery, within and across packages ------------------------------------


def _round_one(pkg, tmp_dir):
    """Four cores propose round 1, persist their state and close."""
    _, cores = _cores(pkg, tmp_dir)
    blocks, proposed = [], []
    for core in cores:
        core.run_block_handler([])
        block = core.try_new_block()
        assert block is not None and block.round() == 1
        proposed.extend((loc.block.digest, loc.offset) for loc in core.block_handler.proposed)
        blocks.append(block.to_bytes())
    for core in cores:
        core.write_state()
        core.wal_writer.close()
    return blocks, proposed


def _round_two(pkg, tmp_dir, raws):
    """Reopen from the WALs, take round 1 from peers, propose round 2, close
    without a state snapshot (recovery must replay the blocks)."""
    _, cores = _cores(pkg, tmp_dir)
    blocks = _decode(pkg, raws)
    out = []
    for core in cores:
        core.add_blocks(blocks[:2])
        assert core.try_new_block() is None
        core.add_blocks(blocks[2:])
        block = core.try_new_block()
        assert block is not None and block.round() == 2
        out.append(block.to_bytes())
    for core in cores:
        core.wal_writer.close()
    return out


def _round_three(pkg, tmp_dir, raws, proposed):
    """Reopen again, take round 2, propose round 3; round 1's transactions
    must be certified everywhere."""
    _, cores = _cores(pkg, tmp_dir)
    types = _mod(pkg, "types")
    blocks = _decode(pkg, raws)
    out = []
    for core in cores:
        core.add_blocks(blocks)
        block = core.try_new_block()
        assert block is not None and block.round() == 3
        out.append((block.to_bytes(), _commits(core)))
        for digest, offset in proposed:
            ref = next(b.reference for r in range(2) for b in core.block_store.get_blocks_by_round(r)
                       if b.reference.digest == digest)
            assert core.block_handler.is_certified(types.TransactionLocator(ref, offset))
    for core in cores:
        core.wal_writer.close()
    return out


def _recovery(tmp_dir, phases):
    r1, proposed = _in_sim(phases[0], _round_one, phases[0], tmp_dir)
    r2 = _in_sim(phases[1], _round_two, phases[1], tmp_dir, r1)
    r3 = _in_sim(phases[2], _round_three, phases[2], tmp_dir, r2, proposed)
    wal = [open(f"{tmp_dir}/wal-{a}", "rb").read() for a in range(4)]
    return r1, r2, r3, wal


@pytest.mark.parametrize("phases", [(PORT, PORT, PORT), (JAX, PORT, JAX), (PORT, JAX, PORT)],
                         ids=["port", "jax-port-jax", "port-jax-port"])
def test_core_recovery(tmp_path, phases):
    """Each phase reopens every core from the WALs the previous phase left;
    in the mixed chains the port recovers from the JAX package's WALs and
    the JAX package from the port's."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = _recovery(str(tmp_path / "a"), phases)
    assert got == _recovery(str(tmp_path / "b"), (JAX, JAX, JAX))  # WAL files included


def test_recovery_from_a_copied_jax_wal_directory(tmp_path):
    """Two port nodes recovering the same JAX-written directory agree with
    each other and with the JAX package on it."""
    (tmp_path / "j").mkdir()
    r1, proposed = _in_sim(JAX, _round_one, JAX, str(tmp_path / "j"))
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    port = _in_sim(PORT, _round_two, PORT, str(tmp_path / "p"), r1)
    assert port == _in_sim(JAX, _round_two, JAX, str(tmp_path / "j"), r1)


# -- the planes the port does not have yet -----------------------------------


def test_default_parameters_never_reach_reconfig_or_execution(tmp_path):
    child = (
        "import sys, tempfile\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from mysticeti_tpu_torch.committee import Committee\n"
        "import test_torch_core as t\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    t._in_sim(t.PORT, t._simple_exchange, t.PORT, d)\n"
        "print(sorted(m for m in sys.modules if m.endswith(('.reconfig', '.execution'))))\n"
    )
    import os

    tests_dir = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(tests_dir))
    out = subprocess.run([sys.executable, "-c", child, tests_dir], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("plane", ["reconfig", "execution"])
def test_the_missing_planes_raise_naming_their_module(tmp_path, plane):
    Parameters = _mod(PORT, "config").Parameters
    Committee = _mod(PORT, "committee").Committee
    committee = Committee.new_test([1] * 4)
    with pytest.raises(ImportError, match=rf"mysticeti_tpu_torch\.{plane}"):
        _open_core(PORT, committee, 0, str(tmp_path), Committee.benchmark_signers(4)[0],
                   Parameters(**{plane: True}))
