"""Headline benchmark: END-TO-END batched Ed25519 verification throughput on
the card (``python -m mysticeti_tpu_torch.bench``).

The port's counterpart of the repository's ``bench.py``.  End to end means
raw bytes in, accept/reject bits out: host packing (numpy byte
concatenation), the key-index lookup, the upload, the prologue kernel
(SHA-512 of R||A||M, mod L, point parse) and the keyed verify kernel are all
inside the timed region, and one combined fetch of the verdicts ends it.
The measured path is the one a validator deploys
(``ops.ed25519.dispatch_indexed_chunks``): the signer set is a known
16-key committee, so each signature ships as R||M||s plus a key index into
the card's key table.

Shape of the measurement: BENCH_PROCS worker processes (default 4) feed the
card concurrently, like validators sharing a host's card, each with its own
CUDA context.  Per trial every worker runs BENCH_ITERS / BENCH_PROCS batches
of BENCH_BATCH signatures; the rate is all signatures over the slowest
worker's time, and the best of the trials wins (at least BENCH_TRIALS, then
more while BENCH_MAX_S lasts, at most BENCH_MAX_TRIALS).  A stall watchdog
kills workers that print nothing for a phase's limit.  BENCH_MESH=N (> 1)
shards every dispatch over N cards (``parallel.mesh``) and raises when
fewer are attached.  BENCH_PROCS=0 runs one trial loop in this process.

The parent builds the kernels once (``ed25519_cuda.build_all``) before it
starts the workers, which then find the libraries on disk.

Prints the card's name and power limit on stderr, then exactly ONE JSON
line on stdout:
  {"metric": "ed25519_verifies_per_sec", "value": N, "unit": "sig/s", "vs_baseline": R}
with the rung that produced it.  ``vs_baseline`` is against 500k sig/s.

Under the target (and unless BENCH_ACCOUNTING=0) the record carries
``accounting``: ``python -m mysticeti_tpu_torch.tools.bench_probe``'s split
of a batch's time on the card (null round trip, host-to-device bandwidth,
kernel-only and end-to-end time) with the wire ceiling at ~100 B a
signature, or the probe's failure.  Every record, the zero record included,
is appended to the port's trend index (``tools.bench_trend.append_record``:
``build/BENCH_TREND.json`` or BENCH_TREND_PATH, with the card's name and
power limit; BENCH_TREND=0 skips it).

Differences from the JAX package's benchmark: the recovery ladder has card
rungs only (fewer processes, then a smaller batch) and no CPU rung, since a
number from the host would hide the card; a total failure prints value 0
and exits non-zero.  The accounting rides in the record rather than on
stderr, and the trend index lies under ``build/``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

BASELINE_TARGET = 500_000.0  # sig-verifies/sec/host (BASELINE.json north star)
N_KEYS = 16


def _build_batch(batch: int, seed: int, device=None):
    """A 16-signer committee over 32-byte block digests: (KeyTable on
    ``device``, pks, msgs, sigs)."""
    import random

    from .crypto import Ed25519PrivateKey
    from .ops import ed25519 as E

    rng = random.Random(seed)
    keys = [
        Ed25519PrivateKey.from_private_bytes(bytes(rng.randrange(256) for _ in range(32)))
        for _ in range(N_KEYS)
    ]
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        key = keys[i % N_KEYS]
        msg = bytes(rng.randrange(256) for _ in range(32))
        pks.append(key.public_key().public_bytes_raw())
        msgs.append(msg)
        sigs.append(key.sign(msg))
    table = E.KeyTable([k.public_key().public_bytes_raw() for k in keys], device=device)
    return table, pks, msgs, sigs


def _run_trial(table, pks, msgs, sigs, iters: int) -> float:
    """One timed trial: ``iters`` full batches, the index lookup and packing
    inside the timed region, every dispatch queued, ONE combined fetch at
    the end."""
    from .ops import ed25519 as E

    batch = len(sigs)
    start = time.perf_counter()
    handles = []
    for _ in range(iters):
        idx = table.indices_for(pks)
        blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))
        handles.extend(E.dispatch_indexed_chunks(blob, table))
    results = E.fetch_handles(handles)
    elapsed = time.perf_counter() - start
    assert results.shape[0] == batch * iters and bool(results.all())
    return elapsed


def _run_trial_mesh(mesh, table, pks, msgs, sigs, iters: int) -> float:
    """Multi-card trial: the committee-indexed blob sharded over the mesh
    (``parallel.mesh._cached_indexed_kernel``), with ``_run_trial``'s
    discipline: every dispatch queued, ONE combined fetch."""
    from .ops import ed25519 as E
    from .parallel.mesh import _cached_indexed_kernel

    kernel = _cached_indexed_kernel(mesh)
    batch = len(sigs)
    start = time.perf_counter()
    handles = []
    for _ in range(iters):
        idx = table.indices_for(pks)
        blob = E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table))
        for s, count, b in E.iter_buckets(batch):
            handles.append((count, kernel(E._pad_to(blob[s:s + count], b), table)[0]))
    results = E.fetch_handles(handles)
    elapsed = time.perf_counter() - start
    assert results.shape[0] == batch * iters and bool(results.all())
    return elapsed


def _worker() -> None:
    """Child-process mode: warm up, then run one timed trial per GO line on
    stdin, reporting {"sigs": N, "elapsed": s} per trial on stdout."""
    import torch

    from .ops import ed25519 as E

    batch = int(os.environ["BENCH_BATCH"])
    iters = int(os.environ["BENCH_WORKER_ITERS"])
    seed = int(os.environ["BENCH_SEED"])
    mesh_n = int(os.environ.get("BENCH_MESH", "0"))
    table, pks, msgs, sigs = _build_batch(batch, seed)
    if mesh_n > 1:
        from .parallel.mesh import make_mesh, sharded_verify_batch_indexed

        cards = torch.cuda.device_count()
        if cards < mesh_n:
            raise RuntimeError(f"BENCH_MESH={mesh_n} but only {cards} card(s) attached")
        mesh = make_mesh(mesh_n)
        ok, total = sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
        assert int(total) == batch and bool(ok.all())

        def trial():
            return _run_trial_mesh(mesh, table, pks, msgs, sigs, iters)
    else:
        ok = E.verify_batch_table(table, pks, msgs, sigs)  # build/load + warm
        assert bool(ok.all()), "benchmark batch must verify"

        def trial():
            return _run_trial(table, pks, msgs, sigs, iters)
    print("READY", flush=True)
    for line in sys.stdin:
        if line.strip() != "GO":
            continue
        elapsed = trial()
        print(json.dumps({"sigs": batch * iters, "elapsed": elapsed}), flush=True)


def _single_process(batch: int, iters: int, trials: int, device=None) -> float:
    """Best sig/s of ``trials`` in-process trials on ``device``."""
    from .ops import ed25519 as E

    table, pks, msgs, sigs = _build_batch(batch, seed=0, device=device)
    ok = E.verify_batch_table(table, pks, msgs, sigs)
    assert bool(ok.all()), "benchmark batch must verify"
    best = 0.0
    for _ in range(trials):
        elapsed = _run_trial(table, pks, msgs, sigs, iters)
        best = max(best, batch * iters / elapsed)
    return best


def _multi_process(batch: int, iters: int, trials: int, procs: int,
                   ready_timeout_s: float, stall_timeout_s: float) -> float:
    """Fleet-shaped measurement: ``procs`` workers, synchronized trials;
    the aggregate rate is total sigs / slowest worker, best trial wins."""
    per_worker_iters = max(1, iters // procs)
    env = dict(os.environ)
    env.update({
        "BENCH_WORKER": "1",
        "BENCH_BATCH": str(batch),
        "BENCH_WORKER_ITERS": str(per_worker_iters),
    })
    # ``python -m`` from the package's parent directory imports this package.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    workers, err_files = [], []
    for w in range(procs):
        wenv = dict(env)
        wenv["BENCH_SEED"] = str(w)
        # Worker stderr goes to a file: a deterministic config error must
        # reach the operator, not vanish while the ladder retries it.
        err = tempfile.TemporaryFile(mode="w+")
        err_files.append(err)
        workers.append(subprocess.Popen(
            [sys.executable, "-m", "mysticeti_tpu_torch.bench"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            env=wenv, text=True, cwd=root,
        ))

    def _worker_stderr_tail(w: int, limit: int = 800) -> str:
        try:
            err_files[w].seek(0)
            return err_files[w].read()[-limit:]
        except OSError:
            return ""

    stop_guard = threading.Event()
    timed_out = threading.Event()
    try:
        # Stall watchdog: kill the workers if no line arrives within the
        # phase's limit, so a hung card fails loud instead of hanging.
        stall = {"t": time.monotonic(),
                 "limit": float(os.environ.get("BENCH_READY_TIMEOUT_S", str(ready_timeout_s)))}

        # The bench runs on the host's clock only, never under the
        # simulator, so its deadlines read the real monotonic clock.
        def _watchdog():
            while not stop_guard.wait(1.0):
                if time.monotonic() - stall["t"] > stall["limit"]:  # lint: ignore[sim-taint]
                    timed_out.set()
                    for p in workers:
                        p.kill()
                    return

        threading.Thread(target=_watchdog, daemon=True).start()

        def _stalled(phase: str):
            return RuntimeError(
                f"no bench worker progress within {stall['limit']:.0f}s during {phase}"
            )

        for w, p in enumerate(workers):
            line = p.stdout.readline().strip()
            stall["t"] = time.monotonic()
            if line != "READY":
                if timed_out.is_set():
                    raise _stalled("warmup")
                raise RuntimeError(f"worker {w} failed to start: {line!r}\n{_worker_stderr_tail(w)}")
        if timed_out.is_set():
            raise _stalled("warmup")
        sys.stderr.write(f"bench: {procs} workers ready\n")
        stall["limit"] = float(os.environ.get("BENCH_STALL_TIMEOUT_S", str(stall_timeout_s)))
        budget_s = float(os.environ.get("BENCH_MAX_S", "240"))
        max_trials = int(os.environ.get("BENCH_MAX_TRIALS", "10"))
        best = 0.0
        started = time.monotonic()
        trial = 0
        while trial < trials or (trial < max_trials and time.monotonic() - started < budget_s):  # lint: ignore[sim-taint]
            trial += 1
            try:
                for p in workers:
                    p.stdin.write("GO\n")
                    p.stdin.flush()
            except (BrokenPipeError, OSError):
                if timed_out.is_set():
                    raise _stalled("a trial") from None
                raise
            sigs_total, slowest = 0, 0.0
            for w, p in enumerate(workers):
                line = p.stdout.readline()
                stall["t"] = time.monotonic()
                if not line.strip():
                    if timed_out.is_set():
                        if best > 0.0:
                            # One wedged worker must not zero completed trials.
                            sys.stderr.write(f"bench: worker {w} wedged on trial {trial}; "
                                             f"emitting best of {trial - 1} completed trial(s)\n")
                            return best
                        raise _stalled("a trial")
                    raise RuntimeError(f"bench worker {w} died mid-trial (exit code {p.poll()})\n"
                                       f"{_worker_stderr_tail(w)}")
                rec = json.loads(line)
                sigs_total += rec["sigs"]
                slowest = max(slowest, rec["elapsed"])
            best = max(best, sigs_total / slowest)
        return best
    finally:
        stop_guard.set()
        for p in workers:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in workers:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for err in err_files:
            try:
                err.close()
            except OSError:
                pass


def ladder(batch: int, iters: int, procs: int) -> list:
    """The recovery ladder: every rung runs on the card.  Fewer processes,
    then one process on a smaller batch; each rung with shorter limits."""
    rungs = [{"procs": procs, "batch": batch, "iters": iters, "ready": 600.0, "stall": 420.0}]
    if procs > 1:
        rungs.append({"procs": max(1, procs // 2), "batch": batch, "iters": iters,
                      "ready": 360.0, "stall": 300.0})
    rungs.append({"procs": 1, "batch": min(batch, max(4096, batch // 4)), "iters": iters,
                  "ready": 300.0, "stall": 240.0})
    for rung in rungs:
        rung["backend"] = "cuda"
    return rungs


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def main() -> None:
    if os.environ.get("BENCH_WORKER") == "1":
        _worker()
        return

    batch = int(os.environ.get("BENCH_BATCH", "16384"))
    iters = int(os.environ.get("BENCH_ITERS", "64"))
    trials = int(os.environ.get("BENCH_TRIALS", "4"))
    procs = int(os.environ.get("BENCH_PROCS", "4"))

    from .ops import ed25519 as E
    from .ops import ed25519_cuda as K

    E.resolve_device(None)  # no card: raise, never measure the host
    sys.stderr.write(f"bench: card {card_line()}\n")
    K.build_all()  # once, before the workers: they find the libraries built

    if procs <= 0:
        _emit(_single_process(batch, iters, trials))
        return

    budget_s = float(os.environ.get("BENCH_LADDER_BUDGET_S", "1800"))
    started = time.monotonic()
    value, used, last_error = 0.0, None, None
    rung_reports = []
    for rung, spec in enumerate(ladder(batch, iters, procs)):
        if rung > 0 and time.monotonic() - started > budget_s:  # lint: ignore[sim-taint]
            rung_reports.append({"rung": rung, "backend": spec["backend"], "ok": False,
                                 "skipped": True, "error": "ladder budget exhausted"})
            sys.stderr.write(f"bench: ladder budget exhausted; skipping rung {rung}\n")
            continue
        try:
            value = _multi_process(spec["batch"], spec["iters"], trials, spec["procs"],
                                   ready_timeout_s=spec["ready"], stall_timeout_s=spec["stall"])
            used = {"rung": rung, "procs": spec["procs"], "batch": spec["batch"],
                    "backend": spec["backend"]}
            rung_reports.append({"rung": rung, "backend": spec["backend"], "ok": True,
                                 "value": round(value, 1)})
            break
        except (RuntimeError, OSError, ValueError) as exc:
            # ValueError covers json.JSONDecodeError from a worker dying
            # mid-print: that too falls to the next rung.
            last_error = exc
            rung_reports.append({"rung": rung, "backend": spec["backend"], "ok": False,
                                 "error": str(exc)[:200]})
            sys.stderr.write(f"bench: rung {rung} ({spec['procs']} procs, batch {spec['batch']}) "
                             f"failed: {exc}\n")
    if value <= 0.0:
        # A total failure still records a parsed (zero) measurement with the
        # per-rung evidence before the non-zero exit.
        _emit(0.0, {"backend": "none", "rungs": rung_reports})
        raise last_error or RuntimeError("bench produced no measurement")
    if used["rung"] > 0:
        used["rungs"] = rung_reports
    if value < BASELINE_TARGET and os.environ.get("BENCH_ACCOUNTING") != "0":
        used["accounting"] = accounting(value)
    _emit(value, used)


def accounting(value: float) -> dict:
    """Why a run fell under the target: the probe's split of a batch's time
    on the card, run as a child, with the wire ceiling at ~100 B a
    signature.  Never raises: a failed probe is recorded, not the end of
    the measurement."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        probe = subprocess.run(
            [sys.executable, "-m", "mysticeti_tpu_torch.tools.bench_probe"],
            capture_output=True, text=True, timeout=420, cwd=root,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return {"error": repr(exc)}
    lines = probe.stdout.strip().splitlines()
    if probe.returncode != 0 or not lines:
        return {"error": f"probe exited {probe.returncode}: {probe.stderr[-400:]}"}
    acct = json.loads(lines[-1])
    bw = acct.get("h2d_MBps")
    if bw:
        acct["wire_ceiling_sig_s_at_100B"] = bw * 1e6 / 100.0
        acct["measured_fraction_of_wire_ceiling"] = value / acct["wire_ceiling_sig_s_at_100B"]
    return acct


def _emit(value: float, used: dict = None) -> None:
    record = {
        "metric": "ed25519_verifies_per_sec",
        "value": round(value, 1),
        "unit": "sig/s",
        "vs_baseline": round(value / BASELINE_TARGET, 4),
    }
    if used:
        # Which ladder rung produced the number.
        record.update(used)
    print(json.dumps(record), flush=True)
    if os.environ.get("BENCH_TREND") != "0":
        from .tools.bench_trend import append_record

        append_record(record)


if __name__ == "__main__":
    main()
