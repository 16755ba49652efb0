"""The port's verify slice end to end, against the JAX package.

Signed blocks are built and serialized by the JAX package, decoded by the
port, checked with ``verify_structure`` and verified through the port's
``_make_verifier(<accelerator kind>)`` on the CPU (the kernels' plain
versions).  The verdicts must equal the JAX package's batching collector
over its CPU oracle on every block, tampered ones included.  Also: no
module of the port, and not ``chip_smoke.py``, imports JAX or the JAX
package.
"""
import ast
import asyncio
import pathlib

import pytest

from mysticeti_tpu import block_validator as JBV
from mysticeti_tpu import committee as JC
from mysticeti_tpu import types as JT
from mysticeti_tpu_torch import committee as C
from mysticeti_tpu_torch import spans
from mysticeti_tpu_torch import types as T
from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, _make_verifier

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_AUTH = 4


def _signed_block_bytes():
    """Serialized blocks of a 4-authority committee over 3 rounds, with
    labels; four of them tampered on the wire or at signing time."""
    signers = JC.Committee.benchmark_signers(N_AUTH)
    prev = [JT.StatementBlock.new_genesis(a).reference for a in range(N_AUTH)]
    out = []
    for rnd in range(1, 4):
        refs = []
        for a in range(N_AUTH):
            txs = [JT.Share(bytes([a, rnd]) * 256)]  # 512-byte transactions
            signer = signers[(a + 1) % N_AUTH] if (rnd, a) == (2, 1) else signers[a]
            includes = prev if (rnd, a) != (3, 2) else prev + [JT.BlockReference(a, rnd, bytes(32))]
            block = JT.StatementBlock.build(a, rnd, includes, txs, signer=signer)
            refs.append(block.reference)
            raw = bytearray(block.to_bytes())
            if (rnd, a) == (1, 3):
                raw[-1] ^= 1  # signature byte
            elif (rnd, a) == (3, 0):
                raw[-100] ^= 1  # share payload: the signed digest changes
            out.append(bytes(raw))
        prev = refs
    return out


def _verdicts(decode, committee, verifier, raws):
    blocks, structural = [], []
    for raw in raws:
        block = decode(raw)
        try:
            block.verify_structure(committee)
            structural.append(True)
        except ValueError:
            structural.append(False)
        blocks.append(block)
    sig_ok = asyncio.run(verifier.verify_blocks(blocks))
    return [s and v for s, v in zip(structural, sig_ok)]


def test_slice_verdicts_equal_the_jax_cpu_collector():
    raws = _signed_block_bytes()
    committee = C.Committee.new_for_benchmarks(N_AUTH)
    port = _make_verifier(ACCELERATOR_KIND, committee, device="cpu")
    assert port.ready.wait(300)
    tracer = spans.SpanTracer()
    previous = spans.install(tracer)
    try:
        got = _verdicts(T.StatementBlock.from_bytes, committee, port, raws)
    finally:
        spans.install(previous)
    jcommittee = JC.Committee.new_for_benchmarks(N_AUTH)
    reference = JBV.BatchedSignatureVerifier(jcommittee, JBV.CpuSignatureVerifier())
    want = _verdicts(JT.StatementBlock.from_bytes, jcommittee, reference, raws)
    assert got == want
    assert got.count(False) == 4  # every tampered block, and only those
    assert {e[0] for e in tracer.events} == set(spans.VERIFY_STAGES)


def test_verifier_kinds():
    committee = C.Committee.new_for_benchmarks(N_AUTH)
    assert _make_verifier("accept", committee).ready.is_set()
    cpu = _make_verifier("cpu", committee)
    raws = _signed_block_bytes()[:4]
    blocks = [T.StatementBlock.from_bytes(r) for r in raws]
    assert asyncio.run(cpu.verify_blocks(blocks)) == [True, True, True, False]
    with pytest.raises(ValueError):
        _make_verifier("tpu", committee)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "mysticeti_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"mysticeti_tpu_torch/{m}.py" for m in (
        "entry", "bench", "verifier_service", "metrics", "spans", "tracing", "network",
        "core_task", "native/__init__", "runtime/__init__", "runtime/simulated", "config",
        "wal", "storage", "block_store", "state", "block_manager", "consensus/__init__",
        "consensus/base_committer", "consensus/universal_committer", "consensus/linearizer",
        "decisions", "threshold_clock", "epoch_close", "range_map", "log", "block_handler",
        "commit_observer", "core", "syncer", "net_sync", "reconfig", "execution",
        "finalization_interpreter", "validator", "cli", "__main__", "tools/perf_attr",
        "adversary", "detsan", "chaos", "scenarios", "tools/detsan",
        "tools/scenario_matrix", "tools/lint", "tools/trace_report", "tools/fleet_trace",
        "tools/fleetmon", *(f"analysis/{m}" for m in (
            "__init__", "__main__", "checker", "cli", "detflow", "races", "lockgraph")),
        "orchestrator/__init__", *(
            f"orchestrator/{m}" for m in (
                "benchmark", "display", "faults", "hostmon", "logs", "measurement",
                "monitor", "orchestrator", "plot", "providers", "runner", "settings", "ssh",
                "testbed")))} <= names
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "mysticeti_tpu"}, path


@pytest.mark.kernel
def test_slice_equals_the_jax_accelerator_backend():
    raws = _signed_block_bytes()
    committee = C.Committee.new_for_benchmarks(N_AUTH)
    port = _make_verifier(ACCELERATOR_KIND, committee, device="cpu")
    assert port.ready.wait(300)
    got = _verdicts(T.StatementBlock.from_bytes, committee, port, raws)
    jcommittee = JC.Committee.new_for_benchmarks(N_AUTH)
    backend = JBV.TpuSignatureVerifier(mesh=None, committee_keys=jcommittee.public_key_bytes())
    reference = JBV.BatchedSignatureVerifier(jcommittee, backend)
    assert got == _verdicts(JT.StatementBlock.from_bytes, jcommittee, reference, raws)
