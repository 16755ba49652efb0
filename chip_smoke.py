#!/usr/bin/env python3
"""Drive the PyTorch/CUDA verify path on one NVIDIA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit, builds the three CUDA kernels
   (one nvcc per source, in parallel) and prints the build time and ptxas's
   register / stack report.
2. For each kernel, at the largest bucket (16,384 lanes) with a 50-key
   committee (BASELINE config 4), holds the kernel against its plain PyTorch
   version on the card, lane for lane, over the seven case classes (valid,
   corrupt R, corrupt s, corrupt message, wrong key, non-canonical s,
   corrupt pk); checks the verdicts against the labels the cases were built
   with and a sample against the Ed25519 oracle; times kernel and plain
   version with CUDA events.  The tolerance is zero: every output is an
   integer or a bit, so "equal" means equal on every element.
3. Drives the main path with every launch count at 0: the signed blocks of a
   50-authority committee over 20 rounds (some tampered) are serialized,
   decoded, checked with ``verify_structure`` and verified through the
   node's verifier (``_make_verifier("cuda-only")``); then one committee
   dispatch of 15,000 signatures (one 16,384-lane bucket) with a few
   unknown-key stragglers.
   Verdicts must equal the oracle's, and every kernel must have launched.
4. Prints a ``{"kernels": [...]}`` line, the end-to-end rate, and as its
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or when any
phase fails.
"""
from __future__ import annotations

import asyncio
import json
import os
import random
import statistics
import subprocess
import sys
import time

SEED = 2026
BUCKET = 16384
COMMITTEE = 50  # BASELINE.json config 4: a 50-validator run
ROUNDS = 20
TX_PER_BLOCK = 4  # 512-byte transactions (the config's size), fewer per block
TX_BYTES = 512
DISTINCT_SIGNATURES = 2000  # signing is ~3 ms each in pure Python
ORACLE_SAMPLE = 300
STRAGGLERS = 8
# Signatures in a keyed chunk: the per-key padding to whole 32-lane tiles
# must fit the bucket (50 keys x 10 tiles = 500 of its 512 tiles), so a
# committee burst of 15,000 signatures fills the 16,384-lane bucket.
KEYED_LANES = 15000
CLASSES = ("valid", "corrupt_R", "corrupt_s", "corrupt_msg", "wrong_key",
           "noncanonical_s", "corrupt_pk")
L = (1 << 252) + 27742317777372353535851937790883648493
P = (1 << 255) - 19

# Least-time bounds (H100 SXM at its published 1.98 GHz boost clock):
# 32-bit integer multiply-add and add/logic run at 64 per SM per clock on
# compute capability 9.0 (half the float32 FMA rate behind the 67 TFLOP/s
# peak), over 132 SMs; device memory moves 3.35 TB/s.
INT_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# A 255-bit field multiply needs at least 8 x 8 32-bit limb products.
INT_MULS_PER_FIELD_MUL = 64
# One SHA-512 compression in 32-bit integer instructions with funnel shifts
# and three-input logic: 80 rounds x 36 + 64 schedule steps x 22.
SHA512_INT_OPS = 80 * 36 + 64 * 22


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def sign_cases(signers, n_lanes: int, rng: random.Random, classes=CLASSES, stragglers=None):
    """``n_lanes`` (pk, msg, sig, label) lanes from DISTINCT_SIGNATURES
    signed digests, repeated and corrupted class by class.  With
    ``stragglers`` set, exactly the first that many lanes carry an unknown
    key and the rest of the corrupt-pk class stays valid."""
    pks = [s.public_key.bytes for s in signers]
    base = []
    for i in range(DISTINCT_SIGNATURES):
        k = i % len(signers)
        msg = rng.randbytes(32)
        base.append((k, msg, signers[k].sign(msg)))
    lanes = []
    for j in range(n_lanes):
        k, msg, sig = base[j % len(base)]
        pk = pks[k]
        cls = classes[(j // len(base) + j) % len(classes)]
        if stragglers is not None:
            cls = "corrupt_pk" if j < stragglers else ("valid" if cls == "corrupt_pk" else cls)
        if cls == "corrupt_R":
            pos = rng.randrange(32)
            sig = sig[:pos] + bytes([sig[pos] ^ (1 << rng.randrange(8))]) + sig[pos + 1:]
        elif cls == "corrupt_s":
            pos = 32 + rng.randrange(32)
            sig = sig[:pos] + bytes([sig[pos] ^ (1 << rng.randrange(8))]) + sig[pos + 1:]
        elif cls == "corrupt_msg":
            pos = rng.randrange(32)
            msg = msg[:pos] + bytes([msg[pos] ^ 1]) + msg[pos + 1:]
        elif cls == "wrong_key":
            pk = pks[(k + 1) % len(pks)]
        elif cls == "noncanonical_s":
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
        elif cls == "corrupt_pk":
            pos = rng.randrange(32)
            pk = pk[:pos] + bytes([pk[pos] ^ 1]) + pk[pos + 1:]
        lanes.append((pk, msg, sig, cls))
    return lanes


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    check(len(got) == len(want), "output counts differ")
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, f"shape/dtype {g.shape} {w.shape}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: int):
    t_ops, t_bytes = ops / INT_OPS_PER_S * 1e3, moved / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def field_muls_per_lane():
    """Field multiplies one lane of each verify does, counted on the plain
    versions (the kernels run the same formulas) on the CPU."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K
    from mysticeti_tpu_torch.ops import field as F

    count = [0]
    mul = F.mul

    def counting(a, b):
        count[0] += 1
        return mul(a, b)

    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    ok = torch.ones(1, dtype=torch.bool)
    F.mul = counting
    try:
        E.verify_impl(z(1, 20), z(1), z(1, 20), z(1), z(1, 64), z(1, 64), ok)
        generic = count[0]
        count[0] = 0
        combs = torch.as_tensor(E.build_neg_key_combs([bytes(32)])[0])
        K.verify_keyed_plain(z(1), combs, z(1, 20), z(1), z(1, 64), z(1, 64), ok, 1)
        keyed = count[0]
    finally:
        F.mul = mul
    return generic, keyed


def oracle(pk: bytes, msg: bytes, sig: bytes) -> bool:
    from mysticeti_tpu_torch import crypto

    try:
        return crypto.PublicKey(pk).verify(sig, msg)
    except ValueError:
        return False


def kernel_phase(signers, table, rng, report):
    """Each kernel against its plain version at BUCKET lanes, on the card."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dev = table.device
    lanes = sign_cases(signers, BUCKET, rng)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    expected = np.array([c == "valid" for c in labels])
    sample = rng.sample(range(BUCKET), ORACLE_SAMPLE)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == expected[i] for i in sample),
          "case labels disagree with the Ed25519 oracle")

    # Prologue, raw and indexed layouts.
    raw = E.to_device_words(E.pack_blob(pks, msgs, sigs), dev)
    idx = table.indices_for(pks)
    indexed = E.to_device_words(E.pack_blob_indexed(idx, msgs, sigs, num_keys=len(table)), dev)
    k_raw = K.prologue(raw)
    err = max_abs_err(k_raw, K._prologue_plain(raw, None))
    err = max(err, max_abs_err(K.prologue(indexed, table.words),
                               K._prologue_plain(indexed, table.words)))
    check(err == 0, f"prologue differs from its plain version (max abs err {err})")
    ms = cuda_ms(lambda: K.prologue(indexed, table.words), 20)
    plain_ms = cuda_ms(lambda: K._prologue_plain(indexed, table.words), 2)
    out_bytes = nbytes(*K.prologue(indexed, table.words))
    b_ms, b_by = bound(BUCKET * SHA512_INT_OPS, nbytes(indexed, table.words) + out_bytes)
    report["prologue"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    generic_muls, keyed_muls = field_muls_per_lane()

    # Generic ladder on the raw prologue outputs.
    got = K.verify_generic(*k_raw)
    want = E.verify_impl(*k_raw)
    err = max_abs_err([got], [want])
    check(err == 0, "generic kernel differs from its plain version")
    check(np.array_equal(got.cpu().numpy(), expected), "generic kernel disagrees with the labels")
    ms = cuda_ms(lambda: K.verify_generic(*k_raw), 5)
    # The collector's flush size (256 signatures): the generic kernel's
    # latency floor, since every lane runs the whole ladder serially.
    head = [t[:256] for t in k_raw]
    ms_256 = cuda_ms(lambda: K.verify_generic(*head), 5)
    plain_ms = cuda_ms(lambda: E.verify_impl(*k_raw), 1)
    live = int(k_raw[-1].sum())
    b_ms, b_by = bound(live * generic_muls * INT_MULS_PER_FIELD_MUL,
                       nbytes(*k_raw, E.base_comb(dev), got))
    report["verify_generic"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, field_muls_per_lane=generic_muls,
                                    ms_at_256_lanes=ms_256)

    # Keyed tiles: every lane of a tile shares one of the 50 keys.
    # The keyed kernel serves committee keys: its chunk holds the known-key
    # lanes (unknown keys ride the generic kernel).
    sel = np.flatnonzero(idx >= 0)[:KEYED_LANES]
    blob = E.pack_blob_indexed(idx[sel], [msgs[i] for i in sel], [sigs[i] for i in sel],
                               num_keys=len(table))
    grouping = E.group_blob_for_tiles(blob, len(table), K.KEYED_TILE, BUCKET)
    check(grouping is not None, "keyed lanes do not fit the bucket")
    grouped, tile_keys, positions = grouping
    outs = K.prologue(E.to_device_words(grouped, dev), table.words)
    tile_keys = torch.as_tensor(tile_keys, device=dev)
    acomb, _ = table.neg_combs()
    args = (tile_keys, acomb, *outs[2:])
    got = K.verify_keyed(*args)
    want = K.verify_keyed_plain(*args, tile=K.KEYED_TILE)
    err = max_abs_err([got], [want])
    check(err == 0, "keyed kernel differs from its plain version")
    check(np.array_equal(got.cpu().numpy()[positions], expected[sel]),
          "keyed kernel disagrees with the labels")
    ms = cuda_ms(lambda: K.verify_keyed(*args), 10)
    plain_ms = cuda_ms(lambda: K.verify_keyed_plain(*args, tile=K.KEYED_TILE), 1)
    live = int(outs[-1].sum())
    b_ms, b_by = bound(live * keyed_muls * INT_MULS_PER_FIELD_MUL,
                       nbytes(tile_keys, acomb, *outs[2:], E.base_comb(dev), got))
    report["verify_keyed"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, field_muls_per_lane=keyed_muls)
    print(f"kernel phase: {BUCKET} lanes x {len(CLASSES)} classes, all three kernels "
          f"equal their plain versions; {ORACLE_SAMPLE} lanes held to the oracle", flush=True)


def build_blocks(signers, rng):
    """Serialized blocks of the committee over ROUNDS rounds; one in
    twenty-five tampered (signature byte, payload byte or wrong signer)."""
    from mysticeti_tpu_torch.types import Share, StatementBlock

    n = len(signers)
    prev = [StatementBlock.new_genesis(a).reference for a in range(n)]
    raws = []
    for rnd in range(1, ROUNDS + 1):
        refs = []
        for a in range(n):
            txs = [Share(rng.randbytes(TX_BYTES)) for _ in range(TX_PER_BLOCK)]
            serial = len(raws)
            kind = (serial // 25) % 3 if serial % 25 == 7 else -1
            signer = signers[(a + 1) % n] if kind == 2 else signers[a]
            block = StatementBlock.build(a, rnd, prev, txs, signer=signer)
            refs.append(block.reference)
            raw = bytearray(block.to_bytes())
            if kind == 0:
                raw[-1 - rng.randrange(64)] ^= 1 << rng.randrange(8)
            elif kind == 1:
                raw[-100] ^= 1
            raws.append(bytes(raw))
        prev = refs
    return raws


def main_path(signers, committee, rng, kernels):
    """The node's verify path, then one committee dispatch of BUCKET lanes."""
    import numpy as np

    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, _make_verifier

    raws = build_blocks(signers, rng)
    verifier = _make_verifier(ACCELERATOR_KIND, committee)
    check(verifier.ready.wait(300), "verifier warmup did not finish")
    blocks = [StatementBlock.from_bytes(r) for r in raws]
    for b in blocks:
        b.verify_structure(committee)
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    verdicts = asyncio.run(verifier.verify_blocks(blocks))
    block_s = time.monotonic() - t0
    want = [oracle(committee.get_public_key(b.author()).bytes, b.signed_digest(), b.signature)
            for b in blocks]
    check(verdicts == want, "block verdicts differ from the oracle's")
    check(want.count(False) > 0, "no tampered block in the run")
    print(f"block path: {len(blocks)} blocks of a {len(signers)}-authority committee, "
          f"{want.count(False)} tampered, verdicts equal the oracle's "
          f"({len(blocks) / block_s:.1f} blocks/s incl. collector windows)", flush=True)

    lanes = sign_cases(signers, KEYED_LANES, rng, stragglers=STRAGGLERS)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    expected = np.array([c == "valid" for c in labels])
    backend = verifier.verifier  # TorchSignatureVerifier: dispatch_batch_table
    check(sum(pk not in set(committee.public_key_bytes()) for pk in pks) == STRAGGLERS,
          "straggler count")
    got = np.asarray(backend.verify_signatures_async(pks, msgs, sigs).result())
    check(np.array_equal(got, expected), "committee dispatch disagrees with the labels")
    sample = rng.sample(range(KEYED_LANES), 100)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == got[i] for i in sample),
          "committee dispatch disagrees with the oracle")
    launches = {k.name: (k.launches, k.lanes) for k in kernels}
    runs = []
    for _ in range(3):
        t0 = time.monotonic()
        backend.verify_signatures_async(pks, msgs, sigs).result()
        runs.append(time.monotonic() - t0)
    rate = KEYED_LANES / statistics.median(runs)
    print(f"committee dispatch: {KEYED_LANES} signatures in one {BUCKET}-lane bucket ({STRAGGLERS} unknown-key stragglers), "
          f"end to end {rate:.0f} sig/s (median of 3, host pack included)", flush=True)
    return launches, rate


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mysticeti_tpu_torch.committee import Committee
        from mysticeti_tpu_torch.ops import cuda_build
        from mysticeti_tpu_torch.ops import ed25519 as E
        from mysticeti_tpu_torch.ops import ed25519_cuda as K
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    print(card_line(), flush=True)
    t0 = time.monotonic()
    K.build_all()
    print(f"build: {time.monotonic() - t0:.1f} s for {len(K.KERNELS)} kernels in parallel", flush=True)
    for name, log in sorted(cuda_build.ptxas_reports.items()):
        for line in log.splitlines():
            if "Used" in line or "stack" in line or "spill" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)

    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    dev = E.resolve_device(None)
    table = E.KeyTable(committee.public_key_bytes(), device=dev)
    report = {}
    kernel_phase(signers, table, rng, report)
    launches, rate = main_path(signers, committee, rng, K.KERNELS)
    for k in K.KERNELS:
        check(launches[k.name][0] > 0, f"{k.name} was not launched on the main path")

    rows = []
    for k in K.KERNELS:
        r = report[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name][0], "lanes": launches[k.name][1],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **{key: r[key] for key in ("field_muls_per_lane", "ms_at_256_lanes") if key in r},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"e2e_sig_per_s": rate, "signatures": KEYED_LANES, "bucket": BUCKET,
                      "committee": COMMITTEE}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    try:
        return run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
