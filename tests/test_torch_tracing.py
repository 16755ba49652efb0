"""The port's logging setup held to ``tests/test_tracing.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``): the env-filter spec, the no-op unset
spec, a forced reinstall resetting per-module levels, the formatter's
cached loop class and the virtual-time and authority prefix.  Beyond it,
the same specs must set the JAX package's levels on the same modules, and
the same records logged under each package's virtual-time loop (at seeded
times, authorities and levels) must format to the same lines, the package
name aside.
"""
import asyncio
import io
import logging
import random

import pytest

from mysticeti_tpu import tracing as JTR
from mysticeti_tpu.runtime import simulated as JSIM
from mysticeti_tpu_torch import tracing as PTR
from mysticeti_tpu_torch.runtime import simulated as PSIM
from torch_reference import suite_on_port

globals().update(suite_on_port("test_tracing.py"))

SIDES = {"jax": (JTR, JSIM), "port": (PTR, PSIM)}
MODULES = ("net_sync", "core", "block_validator", "verifier_service", "wal")
SPECS = ("net_sync=debug,warning", "warning", "debug", "core=info,wal=error,info",
         "verifier_service=debug,off", "error")


def _reset(tracing):
    root = logging.getLogger(tracing.PACKAGE)
    for handler in list(root.handlers):
        root.removeHandler(handler)
    for name in (tracing.PACKAGE, *(f"{tracing.PACKAGE}.{m}" for m in MODULES)):
        logging.getLogger(name).setLevel(logging.NOTSET)


def levels_trace(side):
    tracing, _ = SIDES[side]
    out = []
    try:
        for spec in SPECS:
            _reset(tracing)
            tracing.setup_logging(spec, stream=io.StringIO(), force=True)
            out.append([logging.getLogger(f"{tracing.PACKAGE}.{m}").level for m in MODULES]
                       + [logging.getLogger(tracing.PACKAGE).level])
    finally:
        _reset(tracing)
    return out


def test_spec_levels_as_the_jax_package():
    assert levels_trace("port") == levels_trace("jax")


def lines_trace(side, seed):
    tracing, sim = SIDES[side]
    rng = random.Random(seed)
    stream = io.StringIO()
    _reset(tracing)
    try:
        tracing.setup_logging("core=info,debug", stream=stream, force=True)
        loop = sim.DeterministicLoop(seed=seed)

        async def main():
            for i in range(30):
                await asyncio.sleep(rng.choice((0.0, 0.001, 0.25, 3.5)))
                tracing.current_authority.set(rng.choice((None, 0, 3, 12)))
                level = rng.choice((logging.DEBUG, logging.INFO, logging.WARNING))
                tracing.logger(f"{tracing.PACKAGE}.{rng.choice(MODULES)}").log(
                    level, "record %d: %s", i, rng.random())

        loop.run_until_complete(main())
    finally:
        _reset(tracing)
    return stream.getvalue().splitlines()


@pytest.mark.parametrize("seed", range(3))
def test_virtual_time_lines_as_the_jax_package(seed):
    port = lines_trace("port", seed)
    assert port == lines_trace("jax", seed)
    assert any("record" in line for line in port)
