"""The port's block handler and certified log held to
``tests/test_block_handler.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): the SOFT_MAX slicing of oversize
submissions, an exact budget left whole, the env cap's validation, and
``log_range`` writing the per-locator lines.  Beyond it, the same seeded
mix of ``log`` and ``log_range`` calls over several blocks must write the
JAX package's bytes, and the same seeded submissions must drain into the
same share counts a proposal.
"""
import importlib
import random

import pytest

from torch_reference import suite_on_port

globals().update(suite_on_port("test_block_handler.py"))

PACKAGES = ("mysticeti_tpu", "mysticeti_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def log_bytes(pkg, path, seed):
    types = _mod(pkg, "types")
    rng = random.Random(seed)
    blocks = [types.StatementBlock.new_genesis(a).reference for a in range(4)]
    log = _mod(pkg, "log").TransactionLog.start(path)
    for _ in range(60):
        ref = rng.choice(blocks)
        start = rng.randrange(0, 50)
        if rng.random() < 0.5:
            log.log(types.TransactionLocator(ref, start))
        else:
            log.log_range(ref, start, start + rng.randrange(0, 6))
    log.flush()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", range(3))
def test_certified_log_bytes_as_the_jax_package(tmp_path, seed):
    port, jax = (log_bytes(pkg, str(tmp_path / f"{pkg}.log"), seed) for pkg in PACKAGES[::-1])
    assert port == jax and port


def drain_trace(pkg, seed, monkeypatch):
    bh = _mod(pkg, "block_handler")
    monkeypatch.setattr(bh, "SOFT_MAX_PROPOSED_PER_BLOCK", 16)
    types = _mod(pkg, "types")
    rng = random.Random(seed)
    handler = bh.BenchmarkFastPathBlockHandler(
        _mod(pkg, "committee").Committee.new_for_benchmarks(4), 0)
    out = []
    for _ in range(12):
        for _ in range(rng.randrange(0, 3)):
            handler.submit([bytes([rng.randrange(256)]) * 32
                            for _ in range(rng.randrange(1, 40))])
        statements = handler.handle_blocks([], require_response=True)
        out.append([s.transaction for s in statements if isinstance(s, types.Share)])
        handler.pending_transactions = 0  # as handle_proposal does after proposing
    return out


@pytest.mark.parametrize("seed", range(3))
def test_soft_max_drain_as_the_jax_package(seed, monkeypatch):
    port = drain_trace("mysticeti_tpu_torch", seed, monkeypatch)
    assert port == drain_trace("mysticeti_tpu", seed, monkeypatch)
    assert max(len(shares) for shares in port) == 16
