"""The port's entry points and throughput benchmark, on the CPU.

``entry(device="cpu")`` runs the fused verify step (the prologue and the
generic kernel's plain versions) and must give the JAX package's
``verify_fused_impl`` verdicts on the same packed batch and on a copy with
one bit flipped in R, A, M or s; ``dryrun_multichip`` runs on eight CPU
shards.  The benchmark's in-process trial functions run at batch 64, its
JSON line has the JAX package's keys, and its ladder has no CPU rung: with
no card, nothing of it runs on the host.
"""
import json

import numpy as np
import pytest
import torch

from mysticeti_tpu_torch import bench, entry
from mysticeti_tpu_torch.ops import ed25519 as E

needs_no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="a card is attached")


def _flip(words: np.ndarray, lane: int, col: int, bit: int) -> None:
    words[lane, col] ^= np.uint32(1 << bit)


def test_entry_equals_the_jax_fused_verify():
    """Tolerance: exact (one bool a lane)."""
    import jax.numpy as jnp

    from mysticeti_tpu.ops import ed25519 as JE

    fn, args = entry.entry(device="cpu")
    assert fn is E.verify_fused_impl
    assert all(a.device.type == "cpu" for a in args)
    msg = args[0].numpy().view(np.uint32).copy()
    s = args[1].numpy().view(np.uint32).copy()
    ok = args[2].numpy().copy()
    fmsg, fs = msg.copy(), s.copy()
    # Lanes 0-1: a bit of R; 2-3: of A; 4-5: of M (big-endian words 0-7,
    # 8-15, 16-23); 6-7: of s.
    for lane, (col, bit) in enumerate([(0, 3), (7, 30), (8, 0), (12, 17), (16, 9), (23, 31)]):
        _flip(fmsg, lane, col, bit)
    _flip(fs, 6, 0, 0)
    _flip(fs, 7, 5, 12)
    msg16, s16, ok16 = np.concatenate([msg, fmsg]), np.concatenate([s, fs]), np.concatenate([ok, ok])
    port = fn(E.to_device_words(msg16, "cpu"), E.to_device_words(s16, "cpu"),
              torch.as_tensor(ok16)).numpy()
    want = np.asarray(JE.verify_fused_impl(jnp.asarray(msg16), jnp.asarray(s16), jnp.asarray(ok16)))
    assert port.tolist() == want.tolist()
    assert port[:8].all() and not port[8:].any()
    # The step as entry() hands it over.
    assert fn(*args).tolist() == [True] * 8


@needs_no_card
def test_entries_raise_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_on_eight_cpu_shards():
    entry.dryrun_multichip(8, device="cpu")


def test_dryrun_multichip_takes_a_device_list():
    entry.dryrun_multichip(2, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        entry.dryrun_multichip(2, device=["cpu"] * 3)


def test_run_trial_and_single_process_at_batch_64():
    table, pks, msgs, sigs = bench._build_batch(64, seed=3, device="cpu")
    assert len(table) == bench.N_KEYS and table.device.type == "cpu"
    assert len(set(pks)) == bench.N_KEYS and all(len(m) == 32 for m in msgs)
    assert bench._run_trial(table, pks, msgs, sigs, iters=1) > 0
    assert bench._single_process(64, iters=1, trials=1, device="cpu") > 0


def test_run_trial_mesh_on_two_cpu_shards():
    from mysticeti_tpu_torch.parallel.mesh import make_mesh

    table, pks, msgs, sigs = bench._build_batch(64, seed=4, device="cpu")
    assert bench._run_trial_mesh(make_mesh(devices=["cpu"] * 2), table, pks, msgs, sigs, 1) > 0


def test_emit_prints_one_json_line(capsys):
    bench._emit(750_000.0, {"rung": 0, "procs": 4, "batch": 16384, "backend": "cuda"})
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record == {"metric": "ed25519_verifies_per_sec", "value": 750000.0, "unit": "sig/s",
                      "vs_baseline": 1.5, "rung": 0, "procs": 4, "batch": 16384,
                      "backend": "cuda"}


@pytest.mark.parametrize("procs", [1, 2, 4])
def test_ladder_has_no_cpu_rung(procs):
    rungs = bench.ladder(16384, 64, procs)
    assert [r["procs"] for r in rungs] == ([procs, procs // 2, 1] if procs > 1 else [1, 1])
    assert {r["backend"] for r in rungs} == {"cuda"}
    assert all("env" not in r for r in rungs)  # no JAX_PLATFORMS=cpu style override
    assert rungs[-1]["batch"] == 4096


@needs_no_card
def test_bench_main_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_PROCS", "1")
    monkeypatch.delenv("BENCH_WORKER", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    assert capsys.readouterr().out == ""


@needs_no_card
def test_bench_worker_fails_loud_without_a_card():
    """A worker that cannot reach a card fails the rung with its stderr; it
    never falls back to the host."""
    with pytest.raises(RuntimeError, match="worker 0 failed to start"):
        bench._multi_process(64, 1, 1, 1, ready_timeout_s=120, stall_timeout_s=60)
