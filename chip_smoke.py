#!/usr/bin/env python3
"""Drive the PyTorch/CUDA verify path on one NVIDIA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit, builds the four CUDA kernels
   (one nvcc per source, in parallel) and prints the build time and ptxas's
   register / stack report.
2. For each kernel, at the largest bucket (16,384 lanes) with a 50-key
   committee (BASELINE config 4), holds the kernel against its plain PyTorch
   version on the card, lane for lane, over the seven case classes (valid,
   corrupt R, corrupt s, corrupt message, wrong key, non-canonical s,
   corrupt pk) with the keys in random order; checks the verdicts against
   the labels the cases were built with and a sample against the Ed25519
   oracle; times kernel and plain version with CUDA events (each timed run
   queued behind a spin of the card, so a time is the device's alone).  The
   prologue, the generic kernel and the keyed kernel's lane form (one key
   per lane, as the committee dispatch runs it) are also held to their plain
   versions and timed on 256 lanes (the collector's flush) and on one lane;
   the keyed kernel's tile form (lanes grouped 32 to a key) at 16,384.  The
   keyed plain version reads the 13-bit key combs, the kernel the 51-bit
   lines converted from them.  Then the device time of one 256-signature
   flush of the committee: the prologue and the keyed lane form.  The
   tolerance is zero: every output is an integer or a bit, so "equal" means
   equal on every element.
3. Drives the main path: the signed blocks of a 50-authority committee over
   20 rounds (some tampered) are serialized, decoded, checked with
   ``verify_structure`` and verified through the node's verifier
   (``_make_verifier("cuda-only")``); then one committee dispatch of 15,000
   signatures (one 16,384-lane bucket) with a few unknown-key stragglers.
   Verdicts must equal the oracle's.  The block path must launch the keyed
   kernel and never the generic one; the committee dispatch the keyed
   kernel once and the generic one once (the stragglers).
4. Flat keyed upload: the 15,000-signature grouped chunk of step 2 as the
   flat layout (96 B per signature plus one ok bit), through
   ``verify_keyed_flat``; ``prologue_flat`` must equal its plain version on
   every output, and the verdicts the 26-column keyed path's and the labels.
   Times both layouts, host-to-device copy included.
5. Sharded dispatch: the committee burst of step 3 through
   ``sharded_verify_batch_indexed`` and ``sharded_verify_batch_fused`` on a
   mesh of the distinct cards (with two or more), else of 4 shards on
   ``cuda:0``; verdicts must equal the single-device dispatch, the labels
   and an oracle sample, and the valid count their sum.
6. Hybrid node kind: the blocks of step 3 through ``_make_verifier("cuda")``
   (the CPU/GPU router); verdicts must equal the oracle's, at least one
   batch must take the GPU route and the breaker must end closed.  Prints
   the router's calibration and how many batches took each route.
7. Entry: ``mysticeti_tpu_torch.entry.entry()`` on the card, its 8 verdicts
   all True and the oracle's; a copy with a bit flipped in R, A, M or s
   gives the oracle's verdicts.  Then ``dryrun_multichip(4)`` over the cards
   there are (4 shards on one card).
8. Service: a ``VerifierServer`` on a unix socket under ``build/``, in a
   thread, its backend on ``cuda:0`` and prewarmed; the blocks of step 3
   through ``_make_verifier("cuda-only")`` and then ``("cuda")`` with
   ``MYSTICETI_VERIFIER_SOCKET`` set.  Verdicts must equal the oracle's,
   HELLO_OK must carry a calibration and "cuda", the server must launch the
   keyed kernel and never the generic one, and the hybrid router must not
   be pinned to the CPU.
9. Metrics: the block path of step 3 runs with a ``metrics.Metrics`` and a
   span tracer; prints the pack, device and fetch stage seconds (sums and
   counts), the bytes moved each way, the kernels' build hits and misses,
   and checks the Chrome trace written under ``build/`` has the
   ``verify_*`` spans.
10. Receive: config 4's blocks at full width (50 authorities, 4,000
   transactions of 512 B a block), 5 rounds = 250 blocks, one in 25
   tampered, honest children including only valid blocks, and one forged
   block included by fewer than a quorum.  Authority 0 sends them in
   ``Blocks`` frames under ``MAX_FRAME`` over loopback between two port
   ``TcpNetwork`` endpoints; authority 1 receives them through
   ``_FrameReceiver`` and ``decode_message``, decodes each frame with
   ``StatementBlock.from_bytes_many`` (native, off the loop through
   ``DataPlaneOffload``) and runs ``verify_structure``.  The native
   extension must be built and active.  All 250 blocks go at once through
   ``cuda-only``, ``cuda-only-agg`` and ``cuda-agg``: verdicts equal to the
   oracle's, the forged block rejected, the aggregate kinds skipping blocks
   (skipped + direct = 250), the path launching the keyed kernel and never
   the generic one.  Then ``cuda-only`` and ``cuda-only-agg`` in turns,
   three pairs.  Also timed: the 250 blocks' decode native against the
   pure-Python fallback in this process.
11. Consensus (the consensus-50 cell): config 4's 50 authorities
   (``Committee.new_for_benchmarks(50)``, the benchmark signers) as 50
   ``Syncer``s over a ``Core``, a ``TestBlockHandler``, a
   ``TestCommitObserver`` and a WAL each, under the port's deterministic
   loop for 2.2 virtual seconds: each new own block goes to every peer after
   a seeded 50-100 ms, with 1 s leader timeouts and a 0.25 s relay pump.
   Every delivery is decoded through ``from_bytes_many`` (under the
   simulator's decode memo that is one ``from_bytes`` a block: the batched
   native decode of step 10 is bypassed) and awaited in the receiving
   node's own collector (5 ms window, 256 lanes); all 50 share
   one ``TorchSignatureVerifier`` on cuda:0; the accepted blocks go to
   ``add_blocks``.  One delivery in 50 (seeded) is preceded by a copy with
   a signature bit flipped.  Then the same seed over the ``cpu`` kind.
   Checks: every node commits at least 8 leaders; the committed sequences
   are prefixes of the longest; every forged copy is rejected and none is
   in a store; the sequences and every node's own blocks equal the ``cpu``
   run's; the path launches the prologue and the keyed kernel and never the
   generic one; the signatures that reached the card equal those of the
   deliveries verified.
12. Bench: ``python -m mysticeti_tpu_torch.bench`` as a child with 2
   workers, 8 iterations, 2 trials and a 30 s budget; its JSON line must
   come from rung 0 with a value above 0.
Each path of steps 3-11 (the block path and the committee dispatch of step 3
apart) runs with every launch count set to 0 just before it and read just
after; every kernel must have launched on some path.
13. Prints a ``{"kernels": [...]}`` line, the end-to-end readings, and as its
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or when any
phase fails.

One phase alone: ``python3 -c 'import chip_smoke as c; raise
SystemExit(c.main(c.receive_only))'`` (likewise ``consensus_only``, and
``sharded_only`` for a host with several cards).  Not in the default run:
``receive_split`` (where the receive burst's host time goes) and
``consensus_trace`` (the card's busy share in step 11, from a
``torch.profiler`` trace).

``python3 chip_smoke.py --times NAMES [CHECKOUT]`` runs only the readings of
step 2 that NAMES lists (``all``, or some of prologue, verify_generic,
verify_keyed, verify_keyed_lanes, flush), optionally on the port of
CHECKOUT, a directory inside this checkout (see ``kernel_times``).
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
# A 255-bit field multiply needs at least 8 x 8 32-bit limb products, a
# squaring 8 squares and 28 cross products (each doubled by a shift).
INT_MULS_PER_FIELD_MUL = 64
INT_MULS_PER_FIELD_SQ = 36
# One SHA-512 compression in 32-bit integer instructions with funnel shifts
# and three-input logic: 80 rounds x 36 + 64 schedule steps x 22.
SHA512_INT_OPS = 80 * 36 + 64 * 22
# A reduction of the 512-bit digest mod L (2^252 < L < 2^253) needs at least
# the folds by 2^252 = -c (mod L), c < 2^125 (four 32-bit words): the top 260
# bits times c (9 x 4 32-bit products), the top 133 bits of what is left
# times c (5 x 4), then the last 7 bits (1 x 4).  Charged whichever design
# the kernel runs.
MOD_L_INT_OPS = 9 * 4 + 5 * 4 + 1 * 4
PROLOGUE_INT_OPS = SHA512_INT_OPS + MOD_L_INT_OPS
# The collector's flush (block_validator.BatchedSignatureVerifier).
FLUSH = 256
# Cycles the card spins before a timed run, so the host has enqueued the run
# before the start event executes: a time is then the device's alone, with
# no host gap inside it (about 2 ms at the card's clock).
BUSY_CYCLES = 4_000_000
# What `--times` measures.
TIMED = ("prologue", "verify_generic", "verify_keyed", "verify_keyed_lanes", "flush")
# The receive phase: config 4's blocks at full width (4,000 transactions of
# 512 B, the JAX package's TRANSACTION_SIZE_DEFAULT), depth cut to 5 rounds =
# 250 blocks, one collector flush (max_batch 256); sent as Blocks frames over
# loopback between two TcpNetwork endpoints.
RECEIVE_ROUNDS = 5
RECEIVE_TX = 4000
# The forged block that fewer than a quorum of authorities' valid blocks
# include (round, author); it must be rejected, not aggregated.
BYZANTINE = (2, 20)
RECEIVE_PAIRS = 3  # cuda-only / cuda-only-agg runs in turns
RECEIVE_KINDS = ("cuda-only", "cuda-only-agg", "cuda-agg")
# The native functions the receive path calls; the phase fails without them.
RECEIVE_NATIVE = ("decode_block", "block_digests", "parse_blocks_spans", "split_frames")
# The bench child: a short run of the benchmark's real shape.
BENCH_ENV = {"BENCH_PROCS": "2", "BENCH_ITERS": "8", "BENCH_TRIALS": "2", "BENCH_MAX_S": "30"}
# The consensus phase: config 4's 50 authorities as syncers under the
# deterministic simulator, each delivery verified by the receiving node's own
# collector before the core takes it; one-way latency of the JAX package's
# simulated network (simulated_network.py: 50-100 ms), the syncer harness's
# 1 s leader timeout and 0.25 s relay pump; depth cut to a virtual duration.
CONSENSUS_VIRTUAL_S = 2.2  # 11 commits a node at SEED
CONSENSUS_LATENCY_S = (0.05, 0.10)
CONSENSUS_LEADER_TIMEOUT_S = 1.0
CONSENSUS_PUMP_S = 0.25
CONSENSUS_FORGE_ONE_IN = 50  # deliveries preceded by a copy with a flipped signature bit
CONSENSUS_MIN_COMMITS = 8
HERE = os.path.dirname(os.path.abspath(__file__))


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
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events, each
    run enqueued behind BUSY_CYCLES of spinning (a run that waits for the
    host, as an upload does, still counts the host's time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BUSY_CYCLES)
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


def int_products(lane_ops) -> int:
    """32-bit limb products of the (B, 2) field squarings and multiplies
    ``lane_ops`` (ed25519_cuda.generic_lane_ops / keyed_lane_ops)."""
    sq, mul = (int(x) for x in lane_ops.sum(axis=0))
    return sq * INT_MULS_PER_FIELD_SQ + mul * INT_MULS_PER_FIELD_MUL


def plain_generic_muls_per_lane() -> int:
    """Field multiplies (squarings among them) of one lane of the generic
    verify's plain version, counted on the CPU: a yardstick that stays the
    same whatever the kernel's design."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
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
    finally:
        F.mul = mul
    return count[0]


def oracle(pk: bytes, msg: bytes, sig: bytes) -> bool:
    from mysticeti_tpu_torch import crypto

    try:
        return crypto.PublicKey(pk).verify(sig, msg)
    except ValueError:
        return False


def readings(kernel, plain, args_at, reps: int = 10):
    """``kernel`` against ``plain`` on ``args_at`` ({lanes: args} at BUCKET,
    FLUSH and 1 lanes): the largest difference over the three, the kernel's
    time at each and the plain version's at BUCKET."""
    err = 0
    for args in args_at.values():
        got, want = kernel(*args), plain(*args)
        err = max(err, max_abs_err(*([x] if hasattr(x, "shape") else list(x) for x in (got, want))))
    return dict(max_abs_err=err, ms=cuda_ms(lambda: kernel(*args_at[BUCKET]), reps),
                plain_ms=cuda_ms(lambda: plain(*args_at[BUCKET]), 1),
                ms_at_256_lanes=cuda_ms(lambda: kernel(*args_at[FLUSH]), reps),
                ms_at_1_lane=cuda_ms(lambda: kernel(*args_at[1]), reps))


def lane_sizes(args, lane: int, keep=()):
    """{BUCKET: args, FLUSH: their first FLUSH lanes, 1: lane ``lane``};
    the arguments at the positions ``keep`` stay whole."""
    def cut(sl):
        return tuple(a if i in keep else a[sl] for i, a in enumerate(args))
    return {BUCKET: tuple(args), FLUSH: cut(slice(0, FLUSH)), 1: cut(slice(lane, lane + 1))}


def key_combs(table):
    """The key combs the keyed kernel of the imported port reads: the 51-bit
    lines, or the 13-bit combs of a port from before they existed."""
    return table.neg_combs51() if hasattr(table, "neg_combs51") else table.neg_combs()[0]


def prologue_readings(indexed, words):
    """The prologue on the indexed blob ``indexed`` (BUCKET lanes) and its
    first FLUSH lanes and one lane, against its plain version."""
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    return readings(K.prologue, K._prologue_plain, lane_sizes((indexed, words), 0, keep=(1,)),
                    reps=20)


def generic_readings(k_raw, expected):
    """The generic kernel against its plain version on the prologue outputs
    ``k_raw`` (BUCKET lanes), on their first FLUSH lanes and on one live
    lane; its times at those three sizes."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    got = K.verify_generic(*k_raw)
    check(np.array_equal(got.cpu().numpy(), expected), "generic kernel disagrees with the labels")
    # Every lane runs the whole ladder serially, so one lane is the latency floor.
    lane = int(torch.nonzero(k_raw[-1])[0])
    r = readings(K.verify_generic, E.verify_impl, lane_sizes(k_raw, lane), reps=5)
    check(r["max_abs_err"] == 0, "generic kernel differs from its plain version")
    return r


def keyed_tile_readings(table, pks, msgs, sigs, expected):
    """The tile form of the keyed kernel on the known-key lanes grouped into
    32-lane tiles (the JAX package's layout), against its plain version on
    the 13-bit combs.  Returns the reading and the grouped chunk."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dev = table.device
    idx = table.indices_for(pks)
    sel = np.flatnonzero(idx >= 0)[:KEYED_LANES]
    blob = E.pack_blob_indexed(idx[sel], [msgs[i] for i in sel], [sigs[i] for i in sel],
                               num_keys=len(table))
    grouping = E.group_blob_for_tiles(blob, len(table), K.KEYED_TILE, BUCKET)
    check(grouping is not None, "keyed lanes do not fit the bucket")
    grouped, tile_keys, positions = grouping
    outs = K.prologue(E.to_device_words(grouped, dev), table.words)
    tile_keys = torch.as_tensor(tile_keys, device=dev)
    args = (tile_keys, key_combs(table), *outs[2:])
    got = K.verify_keyed(*args)
    err = max_abs_err([got], [K.verify_keyed_plain(tile_keys, table.neg_combs()[0], *outs[2:],
                                                   tile=K.KEYED_TILE)])
    check(err == 0, "keyed kernel (tile form) differs from its plain version")
    check(np.array_equal(got.cpu().numpy()[positions], expected[sel]),
          "keyed kernel (tile form) disagrees with the labels")
    r = dict(max_abs_err=err, ms=cuda_ms(lambda: K.verify_keyed(*args), 10),
             plain_ms=cuda_ms(lambda: K.verify_keyed_plain(*args, tile=K.KEYED_TILE), 1))
    return r, (grouped, tile_keys.cpu().numpy(), positions, expected[sel]), (args, outs)


def keyed_lane_readings(table, indexed, expected):
    """The lane form of the keyed kernel on the prologue of the indexed blob
    ``indexed`` (BUCKET lanes, keys in random order), against its plain
    version on the 13-bit combs, at BUCKET, FLUSH and 1 lanes."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    outs = K.prologue(indexed, table.words)
    keys = indexed[:, 24].contiguous()
    acomb13 = table.neg_combs()[0]
    got = K.verify_keyed_lanes(keys, table.neg_combs51(), *outs[2:])
    check(np.array_equal(got.cpu().numpy(), expected), "keyed kernel (lane form) disagrees with the labels")
    lane = int(torch.nonzero(outs[-1])[0])
    return readings(lambda k, *rest: K.verify_keyed_lanes(k, table.neg_combs51(), *rest),
                    lambda k, *rest: K.verify_keyed_plain(k, acomb13, *rest, tile=1),
                    lane_sizes((keys, *outs[2:]), lane))


def flush_reading(table, pks, msgs, sigs, expected, kernels):
    """Device time of the work the committee dispatch launches for one
    FLUSH-signature chunk of committee keys, uploaded beforehand: the
    prologue and the keyed lane form (the generic kernel in a port from
    before the lane form).  The launches must be the dispatch's own."""
    import numpy as np

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    idx = table.indices_for(pks)
    sel = np.flatnonzero(idx >= 0)[:FLUSH]
    chunk = E.pack_blob_indexed(idx[sel], [msgs[i] for i in sel], [sigs[i] for i in sel],
                                num_keys=len(table))
    padded = E.to_device_words(chunk, table.device)
    if hasattr(E, "keyed_chunk_on_device"):
        def device_work():
            return E.keyed_chunk_on_device(padded, table)
    else:  # the generic branch of dispatch_indexed_chunks
        def device_work():
            return K.verify_generic(*K.prologue(padded, table.words))

    def launched(fn):
        for k in kernels:
            k.reset_counts()
        out = fn()
        return {k.name: k.launches for k in kernels if k.launches}, out

    by_dispatch, handles = launched(lambda: E.dispatch_indexed_chunks(chunk, table))
    timed, out = launched(device_work)
    check(timed == by_dispatch, f"the timed flush launches {timed}, the dispatch {by_dispatch}")
    check(np.array_equal(E.fetch_handles(handles), expected[sel]), "flush verdicts disagree with the labels")
    check(np.array_equal(out.cpu().numpy(), expected[sel]), "timed flush disagrees with the labels")
    return dict(signatures=len(sel), keys=len(set(idx[sel].tolist())), launches=timed,
                ms=cuda_ms(device_work, 10))


def shuffled_lanes(signers, rng):
    """BUCKET lanes of the seven case classes with the keys in random order."""
    lanes = sign_cases(signers, BUCKET, rng)
    rng.shuffle(lanes)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    return pks, msgs, sigs, labels


def kernel_phase(signers, table, rng, report):
    """Each kernel against its plain version at BUCKET lanes, on the card."""
    import numpy as np

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    dev = table.device
    pks, msgs, sigs, labels = shuffled_lanes(signers, rng)
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
    r = report["prologue"] = prologue_readings(indexed, table.words)
    r["max_abs_err"] = err = max(err, r["max_abs_err"])
    check(err == 0, f"prologue differs from its plain version (max abs err {err})")
    out_bytes = nbytes(*K.prologue(indexed, table.words))
    r["bound_ms"], r["bound_by"] = bound(BUCKET * PROLOGUE_INT_OPS,
                                         nbytes(indexed, table.words) + out_bytes)

    # The generic bound: the squarings and multiplies its lanes do on this
    # run's k (a zero digit adds nothing), and the 51-bit comb it reads.
    # Beside it, the yardstick of the plain version's formulas (every
    # squaring a multiply, the 16-entry table, T everywhere) and 13-bit comb.
    r = report["verify_generic"] = generic_readings(k_raw, expected)
    verdict_bytes = BUCKET  # one byte a lane
    lane_ops = K.generic_lane_ops(k_raw[5], k_raw[6])
    live = int(k_raw[6].sum())
    r["bound_ms"], r["bound_by"] = bound(int_products(lane_ops),
                                         nbytes(*k_raw, E.base_comb51(dev)) + verdict_bytes)
    plain_muls = plain_generic_muls_per_lane()
    r["bound_ms_plain_formulas"] = bound(live * plain_muls * INT_MULS_PER_FIELD_MUL,
                                         nbytes(*k_raw, E.base_comb(dev)) + verdict_bytes)[0]
    r["field_ops_per_lane"] = dict(zip(("squarings", "multiplies"), (lane_ops.sum(axis=0) / live).tolist()))
    r["plain_field_muls_per_lane"] = plain_muls
    r["block_threads"], r["dynamic_smem_bytes"] = K.generic_launch_shape()

    # Keyed, tile form: the known-key lanes grouped, every 32-lane tile under
    # one of the 50 keys (unknown keys ride the generic kernel).  Then the
    # lane form, as the committee dispatch runs it: every lane in random key
    # order under its own key (unknown keys with ok clear).  Its bound: the
    # lanes' field operations and the 51-bit combs it reads.
    r, keyed_chunk, (args, outs) = keyed_tile_readings(table, pks, msgs, sigs, expected)
    lanes = keyed_lane_readings(table, indexed, expected)
    check(lanes["max_abs_err"] == 0, "keyed kernel (lane form) differs from its plain version")
    r["max_abs_err"] = max(r["max_abs_err"], lanes["max_abs_err"])
    r["lane_form_ms"], r["lane_form_plain_ms"] = lanes["ms"], lanes["plain_ms"]
    r["ms_at_256_lanes"], r["ms_at_1_lane"] = lanes["ms_at_256_lanes"], lanes["ms_at_1_lane"]
    lane_ops = K.keyed_lane_ops(outs[-1])
    r["bound_ms"], r["bound_by"] = bound(
        int_products(lane_ops),
        nbytes(args[0], table.neg_combs51(), *outs[2:], E.base_comb51(dev)) + verdict_bytes)
    live = int(outs[-1].sum())
    r["field_ops_per_lane"] = dict(zip(("squarings", "multiplies"), (lane_ops.sum(axis=0) / live).tolist()))
    report["verify_keyed"] = r
    report["flush"] = flush_reading(table, pks, msgs, sigs, expected, K.KERNELS)
    print(f"kernel phase: {BUCKET} lanes x {len(CLASSES)} classes in random key order, prologue, "
          f"generic and keyed (tile and lane forms) kernels equal their plain versions; "
          f"{ORACLE_SAMPLE} lanes held to the oracle; a {FLUSH}-signature flush takes "
          f"{report['flush']['ms']:.3f} ms of device time", flush=True)
    return keyed_chunk


def tampered_kind(serial: int) -> int:
    """How ``build_blocks`` and ``build_receive_blocks`` tamper the block
    with this serial: -1 not at all (one in 25 is), else 0 a signature byte,
    1 a payload byte, 2 a wrong signer."""
    return (serial // 25) % 3 if serial % 25 == 7 else -1


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
            kind = tampered_kind(serial)
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


def main_path(signers, committee, rng, kernels, metrics):
    """The node's verify path, then one committee dispatch of BUCKET lanes.
    The block path runs with ``metrics`` and a span tracer (``metrics_line``
    reads them).  Returns the launch counts of each ({"block": ...,
    "committee": ...}), the dispatch and block rates, the blocks with the
    oracle's verdicts, the committee burst's lanes and the block path's
    metrics reading."""
    import numpy as np

    from mysticeti_tpu_torch import spans
    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, _make_verifier

    raws = build_blocks(signers, rng)
    verifier = _make_verifier(ACCELERATOR_KIND, committee, metrics=metrics)
    check(verifier.ready.wait(300), "verifier warmup did not finish")
    blocks = [StatementBlock.from_bytes(r) for r in raws]
    for b in blocks:
        b.verify_structure(committee)
    moved_before = transfer_bytes(metrics)
    tracer = spans.SpanTracer()
    previous = spans.install(tracer)
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    try:
        verdicts = asyncio.run(verifier.verify_blocks(blocks))
    finally:
        spans.install(previous)
    block_s = time.monotonic() - t0
    launches = {"block": {k.name: k.launches for k in kernels}}
    reading = metrics_line(metrics, moved_before, tracer, len(blocks))
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
    for k in kernels:
        k.reset_counts()
    got = np.asarray(backend.verify_signatures_async(pks, msgs, sigs).result())
    launches["committee"] = {k.name: k.launches for k in kernels}
    check(np.array_equal(got, expected), "committee dispatch disagrees with the labels")
    sample = rng.sample(range(KEYED_LANES), 100)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == got[i] for i in sample),
          "committee dispatch disagrees with the oracle")
    runs = []
    for _ in range(3):
        t0 = time.monotonic()
        backend.verify_signatures_async(pks, msgs, sigs).result()
        runs.append(time.monotonic() - t0)
    rate = KEYED_LANES / statistics.median(runs)
    print(f"committee dispatch: {KEYED_LANES} signatures in one {BUCKET}-lane bucket ({STRAGGLERS} unknown-key stragglers), "
          f"end to end {rate:.0f} sig/s (median of 3, host pack included)", flush=True)
    return (launches, {"committee_sig_per_s": rate, "block_per_s": len(blocks) / block_s},
            (raws, want), (pks, msgs, sigs, expected), reading)


def sample_sum(metrics, name) -> float:
    """The sum of a counter's samples over all its label values."""
    return sum(sample.value for family in metrics.registry.collect()
               for sample in family.samples if sample.name == name)


def transfer_bytes(metrics) -> dict:
    get = metrics.registry.get_sample_value
    return {d: get("mysticeti_device_transfer_bytes_total", {"direction": d}) or 0.0
            for d in ("to_device", "from_device")}


def metrics_line(metrics, moved_before, tracer, n_blocks) -> dict:
    """The block path's stage seconds and transfers, the run's kernel builds,
    and its Chrome trace written under build/ and read back; printed as one
    ``{"metrics": ...}`` line."""
    from mysticeti_tpu_torch import spans

    get = metrics.registry.get_sample_value
    stages = {}
    for stage in ("pack", "device", "fetch"):
        labels = {"stage": stage}
        stages[stage] = {"sum_s": get("verify_pipeline_stage_seconds_sum", labels),
                         "count": get("verify_pipeline_stage_seconds_count", labels)}
        check(stages[stage]["count"], f"no {stage} stage seconds were observed")
    moved = {d: v - moved_before[d] for d, v in transfer_bytes(metrics).items()}
    check(moved["to_device"] > 0 and moved["from_device"] > 0, f"no transfer bytes counted: {moved}")
    builds = {name: get(f"mysticeti_cuda_{name}_total") for name in
              ("builds", "build_seconds", "build_cache_hits", "build_cache_misses")}
    check(builds["build_cache_hits"] + builds["build_cache_misses"] > 0, "no kernel build was counted")
    path = os.path.join(HERE, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracer.write(path)
    events = spans.complete_spans(spans.load_trace_events(path)[0])
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    check(set(by_name) == set(spans.VERIFY_STAGES), f"trace spans {sorted(by_name)}")
    check(by_name["verify_dispatch"] == n_blocks, "a block has no verify_dispatch span")
    reading = {"blocks": n_blocks, "stage_seconds": stages, "transfer_bytes": moved,
               "occupancy": {p: get("mysticeti_verify_occupancy_fraction", {"phase": p})
                             for p in ("pack", "device", "fetch")},
               "builds": builds, "trace": {"path": os.path.relpath(path, HERE), "spans": by_name},
               "dispatches": get("verify_dispatch_batch_size_count")}
    print(json.dumps({"metrics": reading}), flush=True)
    return reading


def flat_phase(table, keyed_chunk, kernels, report):
    """The 15,000-signature grouped chunk of the kernel phase as the flat
    keyed upload: ``verify_keyed_flat`` against the 26-column keyed path."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    grouped, tile_keys, positions, expected = keyed_chunk
    dev = table.device
    acomb = table.neg_combs51()
    flat = E.pack_flat(grouped)
    for k in kernels:
        k.reset_counts()
    got = K.verify_keyed_flat(E.to_device_words(flat, dev), table.words, acomb,
                              torch.as_tensor(tile_keys, device=dev)).cpu().numpy()
    launches = {k.name: k.launches for k in kernels}

    flat_dev = E.to_device_words(flat, dev)
    tk = torch.as_tensor(tile_keys, device=dev)
    outs = K.prologue_flat(flat_dev, table.words, tk)
    err = max_abs_err(outs, K._prologue_flat_plain(flat_dev, table.words, tk, K.KEYED_TILE))
    check(err == 0, f"prologue_flat differs from its plain version (max abs err {err})")
    grouped_dev = E.to_device_words(grouped, dev)
    want = K.verify_keyed(tk, acomb, *K.prologue(grouped_dev, table.words)[2:]).cpu().numpy()
    check(np.array_equal(got, want), "flat keyed verdicts differ from the 26-column keyed path")
    check(np.array_equal(got[positions], expected), "flat keyed verdicts disagree with the labels")

    ms = cuda_ms(lambda: K.prologue_flat(flat_dev, table.words, tk), 20)
    plain_ms = cuda_ms(lambda: K._prologue_flat_plain(flat_dev, table.words, tk, K.KEYED_TILE), 1)
    # At the flush's size and at one lane: the first FLUSH lanes are whole
    # tiles, and their ok bits the first words of the mask.
    head = torch.cat([flat_dev[: FLUSH * 24], flat_dev[BUCKET * 24 : BUCKET * 24 + FLUSH // 32]])
    tk_head = tk[: FLUSH // K.KEYED_TILE].contiguous()
    ms_256 = cuda_ms(lambda: K.prologue_flat(head, table.words, tk_head), 20)
    b_ms, b_by = bound(BUCKET * PROLOGUE_INT_OPS, nbytes(flat_dev, table.words, tk, *outs))
    err = max(err, max_abs_err(K.prologue_flat(head, table.words, tk_head),
                               K._prologue_flat_plain(head, table.words, tk_head, K.KEYED_TILE)))
    check(err == 0, f"prologue_flat differs from its plain version at {FLUSH} lanes")
    report["prologue_flat"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, ms_at_256_lanes=ms_256)

    # Host-to-device copy + prologue + keyed kernel, the two layouts in turns.
    def flat_path():
        K.verify_keyed_flat(E.to_device_words(flat, dev), table.words, acomb,
                            torch.as_tensor(tile_keys, device=dev))

    def col26_path():
        tkd = torch.as_tensor(tile_keys, device=dev)
        outs = K.prologue(E.to_device_words(grouped, dev), table.words)
        K.verify_keyed(tkd, acomb, *outs[2:])

    turns = [("flat", flat_path), ("26col", col26_path), ("26col", col26_path), ("flat", flat_path)]
    times = {"flat": [], "26col": []}
    for name, fn in turns:
        times[name].append(cuda_ms(fn, 5))
    layout = {
        "signatures": int(len(positions)), "lanes": int(grouped.shape[0]),
        "flat_bytes": int(flat.nbytes), "col26_bytes": int(grouped.nbytes),
        "flat_ms": statistics.median(times["flat"]), "col26_ms": statistics.median(times["26col"]),
        "flat_ms_runs": times["flat"], "col26_ms_runs": times["26col"],
    }
    print(f"flat keyed: {len(positions)} signatures in {grouped.shape[0]} lanes, prologue_flat "
          f"equals its plain version, verdicts equal the 26-column keyed path and the labels; "
          f"upload + kernels {layout['flat_ms']:.3f} ms flat ({flat.nbytes} B) vs "
          f"{layout['col26_ms']:.3f} ms 26-column ({grouped.nbytes} B)", flush=True)
    return launches, layout


def sharded_phase(table, burst, rng, kernels):
    """The committee burst through the sharded indexed and fused dispatch."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.parallel import mesh as M

    pks, msgs, sigs, expected = burst
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = M.make_mesh(1 << (cards.bit_length() - 1))
    else:
        mesh = M.make_mesh(devices=[table.device] * 4)  # 4 shards on the one card
    # A card's first use (its context, the kernels' module, the comb and key
    # uploads) is set-up: pay it before the timed run.
    M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    got_i, total_i = M.sharded_verify_batch_indexed(mesh, table, pks, msgs, sigs)
    indexed_s = time.monotonic() - t0
    t0 = time.monotonic()
    got_f, total_f = M.sharded_verify_batch_fused(mesh, pks, msgs, sigs)
    fused_s = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels}

    single = E.verify_batch_table(table, pks, msgs, sigs)
    for name, got, total in (("indexed", got_i, total_i), ("fused", got_f, total_f)):
        check(np.array_equal(got, single), f"sharded {name} verdicts differ from the single-device dispatch")
        check(np.array_equal(got, expected), f"sharded {name} verdicts disagree with the labels")
        check(total == int(got.sum()), f"sharded {name} valid count {total} != {int(got.sum())}")
    sample = rng.sample(range(len(sigs)), 100)
    check(all(oracle(pks[i], msgs[i], sigs[i]) == got_i[i] for i in sample),
          "sharded verdicts disagree with the oracle")
    if cards >= 2:  # the node's verifier shards over the same cards by itself
        from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier

        node = TorchSignatureVerifier(committee_keys=table._keys)
        check(node._resolve_mesh() == mesh, "mesh='auto' did not take the host's cards")
        check(node.verify_signatures(pks, msgs, sigs) == got_i.tolist(),
              "the node verifier's sharded verdicts differ")
    devices = sorted({str(d) for d in mesh.devices})
    reading = {"shards": mesh.size, "devices": devices, "signatures": len(sigs),
               "indexed_s": indexed_s, "fused_s": fused_s, "valid": int(total_i)}
    print(f"sharded: {len(sigs)} signatures over {mesh.size} shards on {devices}, indexed "
          f"{indexed_s * 1e3:.1f} ms, fused {fused_s * 1e3:.1f} ms (host clock, packing "
          f"included); verdicts equal the single-device dispatch, the labels and the oracle",
          flush=True)
    return launches, reading


def hybrid_phase(committee, blocks_and_want, kernels):
    """The node's block path through the hybrid ``cuda`` kind."""
    import threading

    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import HYBRID_KIND, _make_verifier

    raws, want = blocks_and_want
    verifier = _make_verifier(HYBRID_KIND, committee)
    check(verifier.ready.wait(300), "hybrid verifier warmup did not finish")
    hybrid = verifier.verifier
    routes = {"gpu": 0, "cpu": 0}
    lock = threading.Lock()

    def counted(route, fn):
        def call(*args):
            with lock:
                routes[route] += 1
            return fn(*args)
        return call

    hybrid.tpu.verify_signatures_async = counted("gpu", hybrid.tpu.verify_signatures_async)
    hybrid.cpu.verify_signatures = counted("cpu", hybrid.cpu.verify_signatures)
    calibration = {"tpu_dispatch_s": hybrid.tpu_dispatch_s, "tpu_per_sig_s": hybrid.tpu_per_sig_s,
                   "cpu_per_sig_s": hybrid.cpu_per_sig_s, "threshold": hybrid.threshold()}
    blocks = [StatementBlock.from_bytes(r) for r in raws]
    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    verdicts = asyncio.run(verifier.verify_blocks(blocks))
    block_s = time.monotonic() - t0
    launches = {k.name: k.launches for k in kernels}
    check(verdicts == want, "hybrid block verdicts differ from the oracle's")
    check(routes["gpu"] > 0, "no batch took the GPU route")
    check(sum(launches.values()) > 0, "the GPU route launched no kernel")
    check(not hybrid.breaker_open, "the hybrid breaker is open")
    reading = {"calibration": calibration, "batches": dict(routes),
               "blocks": len(blocks), "blocks_per_s": len(blocks) / block_s,
               "after": {"tpu_dispatch_s": hybrid.tpu_dispatch_s,
                         "tpu_per_sig_s": hybrid.tpu_per_sig_s,
                         "cpu_per_sig_s": hybrid.cpu_per_sig_s, "threshold": hybrid.threshold()}}
    print(f"hybrid: {len(blocks)} blocks through the cuda kind, verdicts equal the oracle's; "
          f"calibration {json.dumps(calibration)}; batches by route {json.dumps(routes)} "
          f"(CPU-routed batches are the cost model's choice); {len(blocks) / block_s:.1f} "
          f"blocks/s; breaker closed", flush=True)
    return launches, reading


def entry_phase(kernels):
    """``entry()`` on the card: every verdict True and the oracle's; a copy
    with a bit flipped in R, A, M and s gives the oracle's verdicts.  Then
    ``dryrun_multichip(4)`` over the cards there are."""
    import numpy as np
    import torch

    from mysticeti_tpu_torch import entry
    from mysticeti_tpu_torch.ops import ed25519 as E

    def lanes_of(msg, s):  # the (pk, msg, sig) bytes of each packed lane
        rows = msg.astype(">u4").tobytes()
        tails = s.astype("<u4").tobytes()
        return [(rows[96 * i + 32: 96 * i + 64], rows[96 * i + 64: 96 * i + 96],
                 rows[96 * i: 96 * i + 32] + tails[32 * i: 32 * i + 32]) for i in range(len(msg))]

    for k in kernels:
        k.reset_counts()
    fn, args = entry.entry()
    check(all(a.device.type == "cuda" for a in args), "entry() did not place its batch on the card")
    got = fn(*args).cpu().numpy()
    msg = args[0].cpu().numpy().view(np.uint32).copy()
    s = args[1].cpu().numpy().view(np.uint32).copy()
    want = [oracle(*lane) for lane in lanes_of(msg, s)]
    check(got.tolist() == [True] * 8 and want == [True] * 8, f"entry verdicts {got.tolist()}")
    for lane, (col, bit) in enumerate([(0, 3), (7, 30), (8, 0), (12, 17), (16, 9), (23, 31)]):
        msg[lane, col] ^= np.uint32(1 << bit)
    s[6, 0] ^= np.uint32(1)
    s[7, 5] ^= np.uint32(1 << 12)
    bad = fn(E.to_device_words(msg, args[0].device), E.to_device_words(s, args[0].device),
             args[2]).cpu().numpy()
    want_bad = [oracle(*lane) for lane in lanes_of(msg, s)]
    check(bad.tolist() == want_bad, f"corrupted entry verdicts {bad.tolist()} != oracle {want_bad}")
    entry_counts = {k.name: k.launches for k in kernels}
    print(f"entry: verify_fused_impl on {args[0].device}, 8 valid signatures True, a copy with "
          f"bits flipped in R, A, M and s gives the oracle's verdicts {want_bad}", flush=True)

    for k in kernels:
        k.reset_counts()
    t0 = time.monotonic()
    entry.dryrun_multichip(4)
    dryrun_s = time.monotonic() - t0
    dryrun_counts = {k.name: k.launches for k in kernels}
    check(dryrun_counts["prologue"] > 0 and dryrun_counts["verify_generic"] > 0,
          f"dryrun_multichip launched {dryrun_counts}")
    print(f"dryrun: dryrun_multichip(4) over {torch.cuda.device_count()} card(s) passed in "
          f"{dryrun_s:.1f} s", flush=True)
    return entry_counts, dryrun_counts


class ServiceThread:
    """A ``VerifierServer`` serving on a unix socket from its own event loop
    in a thread; ``start`` returns once the backend is prewarmed."""

    def __init__(self, path, keys, device):
        import threading

        from mysticeti_tpu_torch.metrics import Metrics
        from mysticeti_tpu_torch.verifier_service import VerifierServer

        self.server = VerifierServer(path, committee_keys=keys, metrics=Metrics(), device=device)
        self._ready = threading.Event()
        self._error = None
        self._loop = None
        self._thread = threading.Thread(target=self._run, name="verifier-service", daemon=True)

    def _run(self):
        async def serve():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            try:
                await self.server.start()
                await self._loop.run_in_executor(None, self.server.prewarm)
            except Exception as exc:  # noqa: BLE001 - raised again by start()
                self._error = exc
                self._stop.set()
            self._ready.set()
            await self._stop.wait()
            await self.server.stop()

        asyncio.run(serve())

    def start(self):
        self._thread.start()
        check(self._ready.wait(300), "the verifier service did not warm up")
        if self._error is not None:
            self._thread.join(60)
            raise self._error

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(60)
        check(not self._thread.is_alive(), "the verifier service thread did not stop")


def service_phase(committee, blocks_and_want, kernels, in_process_per_s):
    """The block path through the shared verifier service, ``cuda-only``
    then ``cuda`` kind."""
    from mysticeti_tpu_torch.block_validator import HybridSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.types import StatementBlock
    from mysticeti_tpu_torch.validator import ACCELERATOR_KIND, HYBRID_KIND, _make_verifier
    from mysticeti_tpu_torch.verifier_service import ENV_SOCKET, RemoteSignatureVerifier

    raws, want = blocks_and_want
    path = os.path.join(HERE, "build", "svc", "verifier.sock")
    service = ServiceThread(path, committee.public_key_bytes(), "cuda:0")
    service.start()
    os.environ[ENV_SOCKET] = path
    reading = {"socket": os.path.relpath(path, HERE)}
    try:
        for k in kernels:
            k.reset_counts()
        for kind in (ACCELERATOR_KIND, HYBRID_KIND):
            metrics = Metrics()
            verifier = _make_verifier(kind, committee, metrics=metrics)
            check(verifier.ready.wait(300), f"{kind} warmup through the service did not finish")
            backend = verifier.verifier
            remote = backend.tpu if isinstance(backend, HybridSignatureVerifier) else backend
            check(isinstance(remote, RemoteSignatureVerifier), f"{kind} did not take the service")
            check(remote.dispatch_calibration() is not None, "HELLO_OK carried no calibration")
            check(remote.advertised_backend == "cuda",
                  f"HELLO_OK advertised {remote.advertised_backend!r}, not 'cuda'")
            if kind == HYBRID_KIND:
                check(backend.pinned_backend is None, "the hybrid router is pinned to the CPU")
            blocks = [StatementBlock.from_bytes(r) for r in raws]
            t0 = time.monotonic()
            verdicts = asyncio.run(verifier.verify_blocks(blocks))
            elapsed = time.monotonic() - t0
            check(verdicts == want, f"{kind} verdicts through the service differ from the oracle's")
            get = metrics.registry.get_sample_value
            reading[kind] = {
                "blocks_per_s": len(blocks) / elapsed,
                "calibration": list(remote.dispatch_calibration()),
                "advertised_backend": remote.advertised_backend,
                "wire_bytes": {d: get("verify_wire_bytes_total", {"direction": d})
                               for d in ("sent", "recv")},
            }
        launches = {k.name: k.launches for k in kernels}
    finally:
        os.environ.pop(ENV_SOCKET, None)
        service.stop()
    server_get = service.server.metrics.registry.get_sample_value
    reading["server_dispatches"] = server_get("verify_dispatch_batch_size_count")
    reading["in_process_blocks_per_s"] = in_process_per_s
    check(launches["verify_keyed"] > 0, f"the service launched no keyed kernel: {launches}")
    check(launches["verify_generic"] == 0, f"the service launched the generic kernel: {launches}")
    print(f"service: {len(raws)} blocks through the verifier service on {reading['socket']}, "
          f"cuda-only {reading[ACCELERATOR_KIND]['blocks_per_s']:.1f} blocks/s and hybrid "
          f"{reading[HYBRID_KIND]['blocks_per_s']:.1f} blocks/s (in process cuda-only "
          f"{in_process_per_s:.1f}); verdicts equal the oracle's; HELLO_OK advertised 'cuda' "
          f"with a calibration; server launches {launches}", flush=True)
    return launches, reading


def build_receive_blocks(committee, signers, rng, rounds=RECEIVE_ROUNDS, txs=RECEIVE_TX):
    """Serialized blocks of an aggregation-shaped DAG: as ``build_blocks``,
    but honest children include only the previous round's valid blocks (what
    honest nodes do), and the BYZANTINE block is signed by another key and
    included by the valid blocks of one authority fewer than a quorum.
    Returns the raws, which are valid, and the BYZANTINE block's index."""
    from mysticeti_tpu_torch.types import Share, StatementBlock

    n = len(signers)
    byz_round, byz_author = BYZANTINE
    endorsers = [a for a in range(n) if tampered_kind(byz_round * n + a) < 0]
    endorsers = set(endorsers[: committee.quorum_threshold() - 1])
    prev = [StatementBlock.new_genesis(a).reference for a in range(n)]
    raws, valid, byz_ref, byz_index = [], [], None, None
    for rnd in range(1, rounds + 1):
        good = []
        for a in range(n):
            serial = len(raws)
            kind = tampered_kind(serial)
            byzantine = (rnd, a) == BYZANTINE
            signer = signers[(a + 1) % n] if kind == 2 or byzantine else signers[a]
            includes = list(prev)
            if rnd == byz_round + 1 and a in endorsers:
                includes.append(byz_ref)
            block = StatementBlock.build(
                a, rnd, includes, [Share(rng.randbytes(TX_BYTES)) for _ in range(txs)],
                signer=signer)
            raw = bytearray(block.to_bytes())
            if kind == 0:
                raw[-1 - rng.randrange(64)] ^= 1 << rng.randrange(8)
            elif kind == 1:
                raw[-100] ^= 1
            raws.append(bytes(raw))
            valid.append(kind < 0 and not byzantine)
            if valid[-1]:
                good.append(block.reference)
            if byzantine:
                byz_ref, byz_index = block.reference, serial
        prev = good
    return raws, valid, byz_index


def frames_under_cap(raws, per_round):
    """Each round's blocks split into ``Blocks`` frames, each holding as
    many blocks as fit under MAX_FRAME by their encoded size."""
    from mysticeti_tpu_torch.network import MAX_FRAME

    frames = []
    for start in range(0, len(raws), per_round):
        frame, size = [], 1 + 4  # tag, count
        for raw in raws[start: start + per_round]:
            if frame and size + 4 + len(raw) > MAX_FRAME:
                frames.append(frame)
                frame, size = [], 1 + 4
            frame.append(raw)
            size += 4 + len(raw)
        frames.append(frame)
    return frames


async def over_loopback(frames, streaming=True):
    """Authority 0 sends ``frames`` to authority 1 over two port
    ``TcpNetwork`` endpoints on 127.0.0.1; authority 1 decodes each frame
    with ``from_bytes_many`` on the data-plane offload worker, as it arrives
    (``streaming``, what a node does) or, for ``receive_split``, once the
    last frame is in.  Returns the decoded blocks, the seconds from the first
    send to the last decode, the seconds to the last frame received, the
    decode seconds and the bytes authority 1 received."""
    from mysticeti_tpu_torch.core_task import DataPlaneOffload
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.network import Blocks, TcpNetwork
    from mysticeti_tpu_torch.types import StatementBlock

    addresses = [("127.0.0.1", 0), ("127.0.0.1", 0)]
    receiver_metrics = Metrics()
    net1 = await TcpNetwork.start(1, addresses, receiver_metrics)
    addresses[1] = ("127.0.0.1", net1._server.sockets[0].getsockname()[1])
    net0 = await TcpNetwork.start(0, addresses, Metrics())
    offload = DataPlaneOffload(metrics=receiver_metrics)
    try:
        conn0 = await asyncio.wait_for(net0.connections.get(), 30)
        conn1 = await asyncio.wait_for(net1.connections.get(), 30)
        check(offload.active(), "the data-plane offload is inactive (no native extension)")
        t0 = time.monotonic()

        async def send():
            for frame in frames:
                await conn0.send(Blocks(tuple(frame)))

        async def decode(msg):
            check(offload.should_offload(sum(len(b) for b in msg.blocks)),
                  "a frame too small for the offload")
            d0 = time.monotonic()
            blocks.extend(await offload.run("decode", StatementBlock.from_bytes_many, msg.blocks))
            return time.monotonic() - d0

        sender = asyncio.ensure_future(send())
        blocks, held, decode_s = [], [], 0.0
        for frame in frames:
            msg = await asyncio.wait_for(conn1.recv(), 60)
            check(type(msg) is Blocks and len(msg.blocks) == len(frame),
                  f"received {type(msg).__name__} instead of a {len(frame)}-block frame")
            check(all(type(b) is memoryview for b in msg.blocks),
                  "the frame did not come through the zero-copy receiver")
            if streaming:
                decode_s += await decode(msg)
            else:
                held.append(msg)
        received_s = time.monotonic() - t0
        for msg in held:
            decode_s += await decode(msg)
        wire_s = time.monotonic() - t0
        await sender
        received = receiver_metrics.registry.get_sample_value(
            "mesh_wire_bytes_total", {"direction": "received"})
    finally:
        offload.stop()
        await net0.stop()
        await net1.stop()
    return blocks, wire_s, received_s, decode_s, received


def decode_times(raws):
    """Seconds to decode ``raws`` with ``from_bytes_many`` and have each
    block's signed digest: native, then the per-raw pure-Python fallback in
    this process (the native hooks switched off for the call)."""
    from mysticeti_tpu_torch import types as T

    def timed():
        t0 = time.monotonic()
        blocks = T.StatementBlock.from_bytes_many(raws)
        for b in blocks:
            b.signed_digest()
        return time.monotonic() - t0, blocks

    native_s, native_blocks = timed()
    hooks = T._native_decode, T._native_block_digests
    T._native_decode = T._native_block_digests = None
    try:
        fallback_s, fallback_blocks = timed()
    finally:
        T._native_decode, T._native_block_digests = hooks
    check([b.signed_digest() for b in native_blocks] == [b.signed_digest() for b in fallback_blocks]
          and all(b._stamps is None for b in fallback_blocks),
          "the fallback decode differs from the native one, or did not run")
    return native_s, fallback_s


def receive_phase(committee, signers, rng, kernels):
    """The wire receive path at config 4's full width, then the verifier
    kinds on the received burst (see the module docstring, step 10)."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.metrics import Metrics
    from mysticeti_tpu_torch.native import active_functions
    from mysticeti_tpu_torch.validator import _make_verifier

    active = active_functions()
    check(set(RECEIVE_NATIVE) <= set(active),
          f"the native extension lacks {sorted(set(RECEIVE_NATIVE) - set(active))}")
    n = len(signers)
    t0 = time.monotonic()
    raws, valid, byz_index = build_receive_blocks(committee, signers, rng, RECEIVE_ROUNDS,
                                                  RECEIVE_TX)
    build_s = time.monotonic() - t0
    frames = frames_under_cap(raws, n)
    blocks, wire_s, _, wire_decode_s, received = asyncio.run(over_loopback(frames))
    check([b.to_bytes() for b in blocks] == raws, "the received blocks differ from the sent ones")
    check(all(b._signed_digest is not None and b._stamps is not None for b in blocks),
          "a received block has no precomputed signed digest: the native decode did not run")
    for b in blocks:
        b.verify_structure(committee)
    want = [oracle(committee.get_public_key(b.author()).bytes, b.signed_digest(), b.signature)
            for b in blocks]
    check(want == valid, "the oracle disagrees with the blocks' labels")
    native_s, fallback_s = decode_times(raws)
    reading = {"blocks": len(blocks), "block_bytes": len(raws[0]), "frames": len(frames),
               "blocks_per_frame": [len(f) for f in frames[: len(frames) // RECEIVE_ROUNDS]],
               "bytes_received": received, "wire_s": wire_s, "wire_decode_s": wire_decode_s,
               "decode_native_s": native_s, "decode_fallback_s": fallback_s,
               "native_over_fallback": native_s / fallback_s, "build_s": build_s,
               "tampered": want.count(False), "native_functions": list(active)}
    print(f"receive: {len(blocks)} blocks of {len(raws[0])} B in {len(frames)} frames, "
          f"{received:.0f} B received over loopback in {wire_s:.3f} s decoding each frame as "
          f"it arrives ({wire_decode_s:.3f} s of it decoding); decode native {native_s:.3f} s, "
          f"fallback {fallback_s:.3f} s ({native_s / fallback_s:.3f}x) [{card_line()}]",
          flush=True)

    # Every kind's warmup (kernel loads, key combs, the hybrid's calibration)
    # runs before the counts are zeroed: they count the receive path only.
    verifiers, registries = {}, {}
    for kind in RECEIVE_KINDS:
        registries[kind] = Metrics()
        verifier = verifiers[kind] = _make_verifier(kind, committee, metrics=registries[kind])
        check(verifier.ready.wait(300), f"{kind} warmup did not finish")
        check(verifier.aggregate == kind.endswith("-agg"), f"{kind} aggregate mode")
    for k in kernels:
        k.reset_counts()
    for kind, verifier in verifiers.items():
        metrics = registries[kind]
        t0 = time.monotonic()
        verdicts = asyncio.run(verifier.verify_blocks(blocks))
        elapsed = time.monotonic() - t0
        check(verdicts == want, f"{kind} verdicts differ from the oracle's")
        check(verdicts[byz_index] is False, f"{kind} accepted the forged block")
        check(verifier.aggregated_total + verifier.direct_total == len(blocks),
              f"{kind}: {verifier.aggregated_total} aggregated + {verifier.direct_total} "
              f"direct != {len(blocks)}")
        if verifier.aggregate:
            check(verifier.aggregated_total > 0, f"{kind} skipped no block")
        get = metrics.registry.get_sample_value
        dispatched = get("verify_dispatch_batch_size_sum") or 0.0
        reading[kind] = {"blocks_per_s": len(blocks) / elapsed,
                         "aggregated": verifier.aggregated_total, "direct": verifier.direct_total,
                         "signatures_dispatched": dispatched,
                         "dispatches": get("verify_dispatch_batch_size_count"),
                         "lanes": dispatched + sample_sum(metrics, "verify_padding_wasted_total")}
    launches = {k.name: k.launches for k in kernels}
    check(launches["verify_keyed"] > 0 and launches["prologue"] > 0,
          f"the receive path did not take the prologue and the keyed kernel: {launches}")
    check(launches["verify_generic"] == 0, f"the receive path launched the generic kernel: {launches}")

    rates = {kind: [] for kind in RECEIVE_KINDS[:2]}
    for _ in range(RECEIVE_PAIRS):
        for kind in RECEIVE_KINDS[:2]:
            made = verifiers[kind]
            fresh = BatchedSignatureVerifier(committee, made.verifier, max_delay_s=made.max_delay_s,
                                             aggregate=made.aggregate)
            t0 = time.monotonic()
            verdicts = asyncio.run(fresh.verify_blocks(blocks))
            rates[kind].append(len(blocks) / (time.monotonic() - t0))
            check(verdicts == want, f"{kind} verdicts differ from the oracle's in turn")
    reading["turns_blocks_per_s"] = rates
    reading["median_blocks_per_s"] = {k: statistics.median(v) for k, v in rates.items()}
    only, agg = (reading["median_blocks_per_s"][k] for k in RECEIVE_KINDS[:2])
    reading["agg_over_only"] = agg / only
    reading["card"] = card_line()
    print(f"receive: verdicts equal the oracle's for {', '.join(RECEIVE_KINDS)}; forged block "
          f"{byz_index} rejected; aggregated {reading['cuda-only-agg']['aggregated']} / direct "
          f"{reading['cuda-only-agg']['direct']} (cuda-only-agg), signatures dispatched "
          f"{reading['cuda-only']['signatures_dispatched']:.0f} vs "
          f"{reading['cuda-only-agg']['signatures_dispatched']:.0f}; median blocks/s in turns "
          f"cuda-only {only:.1f}, cuda-only-agg {agg:.1f} ({agg / only:.3f}x); launches "
          f"{launches} [{reading['card']}]", flush=True)
    return launches, reading


def forged_copy(raw: bytes, rng: random.Random) -> bytes:
    """``raw`` with one bit of its signature (the block's last 64 bytes)
    flipped."""
    out = bytearray(raw)
    out[len(out) - 64 + rng.randrange(64)] ^= 1 << rng.randrange(8)
    return bytes(out)


async def consensus_sim(n, tmp_dir, virtual_s, make_collector, forge_one_in):
    """``n`` syncers of a ``Committee.new_for_benchmarks(n)`` under the
    running deterministic loop, the harness of ``tests/test_syncer_sim.py``
    with each delivery verified: the wire bytes are decoded through
    ``from_bytes_many`` (one memoised ``from_bytes`` a block under the
    simulator), awaited in the receiving node's own collector
    (``make_collector(committee)``), and only the accepted blocks reach
    ``add_blocks`` before the node relays.  One delivery in
    ``forge_one_in`` (seeded) is preceded by a copy of its last block with
    a signature bit flipped.  Every node cleans up as often as the node's
    own periodic task does (``net_sync.CLEANUP_INTERVAL_S``).  Returns the
    committed-leader sequences, every node's own-block references, the
    forged copies' references, the rounds reached and the delivery counts."""
    from mysticeti_tpu_torch.block_handler import TestBlockHandler
    from mysticeti_tpu_torch.block_store import BlockStore
    from mysticeti_tpu_torch.commit_observer import TestCommitObserver
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.config import Parameters
    from mysticeti_tpu_torch.core import Core, CoreOptions
    from mysticeti_tpu_torch.net_sync import CLEANUP_INTERVAL_S, AsyncSignals
    from mysticeti_tpu_torch.syncer import Syncer
    from mysticeti_tpu_torch.types import AuthoritySet, StatementBlock
    from mysticeti_tpu_torch.wal import walf

    loop = asyncio.get_running_loop()
    rng = loop.rng
    committee = Committee.new_for_benchmarks(n)
    signers = Committee.benchmark_signers(n)
    parameters = Parameters()
    everyone = AuthoritySet()
    for a in range(n):
        everyone.insert(a)
    syncers, collectors = [], []
    for a in range(n):
        writer, reader = walf(os.path.join(tmp_dir, f"wal-{a}"))
        recovered, _ = BlockStore.open(a, reader, writer, committee)
        handler = TestBlockHandler(last_transaction=a * 1_000_000, committee=committee, authority=a)
        core = Core(block_handler=handler, authority=a, committee=committee, parameters=parameters,
                    recovered=recovered, wal_writer=writer, options=CoreOptions.test(),
                    signer=signers[a])
        observer = TestCommitObserver(core.block_store, committee)
        syncers.append(Syncer(core, parameters.wave_length, AsyncSignals(), observer))
        collectors.append(make_collector(committee))
    counts = {"deliveries": 0, "signatures_verified": 0, "forged": 0, "forged_rejected": 0,
              "honest_rejected": 0}
    forged_refs, errors, inflight = [], [], set()
    cursors = [[0] * n for _ in range(n)]

    def spawn(coro):
        task = asyncio.ensure_future(coro)
        inflight.add(task)
        task.add_done_callback(landed)

    def landed(task):
        inflight.discard(task)
        if not task.cancelled() and task.exception() is not None:
            errors.append(task.exception())

    def arrive(dst, raws, forged):
        if forged is not None:
            spawn(deliver(dst, [forged], True))
        spawn(deliver(dst, raws, False))

    def relay_from(src):
        for dst in range(n):
            if dst == src:
                continue
            blocks = syncers[src].core.block_store.get_own_blocks(cursors[src][dst], 100)
            if not blocks:
                continue
            cursors[src][dst] = max(b.round() for b in blocks)
            low, high = CONSENSUS_LATENCY_S
            delay = low + rng.random() * (high - low)
            raws = [b.to_bytes() for b in blocks]
            forged = forged_copy(raws[-1], rng) if rng.randrange(forge_one_in) == 0 else None
            loop.call_later(delay, arrive, dst, raws, forged)

    async def deliver(dst, raws, forged):
        blocks = StatementBlock.from_bytes_many(raws)
        check(all(b is not None for b in blocks), "a delivered block did not decode")
        verdicts = await collectors[dst].verify_blocks(blocks)
        counts["deliveries"] += 1
        counts["signatures_verified"] += len(blocks)
        if forged:
            counts["forged"] += 1
            forged_refs.append(blocks[0].reference)
            counts["forged_rejected"] += not verdicts[0]
            return
        counts["honest_rejected"] += verdicts.count(False)
        syncers[dst].add_blocks([b for b, ok in zip(blocks, verdicts) if ok], everyone.copy())
        relay_from(dst)

    async def leader_timeout(idx):
        syncer = syncers[idx]
        while True:
            waiter = syncer.signals.round_notify.subscribe()
            round_at_start = syncer.signals.current_round
            try:
                await asyncio.wait_for(waiter.wait(), timeout=CONSENSUS_LEADER_TIMEOUT_S)
            except asyncio.TimeoutError:
                syncer.force_new_block(round_at_start + 1, everyone.copy())
                relay_from(idx)

    async def pump(idx):
        while True:
            await asyncio.sleep(CONSENSUS_PUMP_S)
            relay_from(idx)

    async def cleanup():
        while True:
            await asyncio.sleep(CLEANUP_INTERVAL_S)
            for syncer in syncers:
                syncer.cleanup()

    for idx, syncer in enumerate(syncers):
        syncer.force_new_block(1, everyone.copy())
        relay_from(idx)
    tasks = ([asyncio.ensure_future(leader_timeout(i)) for i in range(n)]
             + [asyncio.ensure_future(pump(i)) for i in range(n)]
             + [asyncio.ensure_future(cleanup())])
    await asyncio.sleep(virtual_s)
    for task in tasks + list(inflight):
        task.cancel()
    await asyncio.gather(*tasks, *inflight, return_exceptions=True)
    check(not errors, f"a delivery failed: {errors[:3]!r}")
    stored_forged = sum(s.core.block_store.block_exists(ref) for s in syncers for ref in forged_refs)
    result = {
        "sequences": [list(s.commit_observer.committed_leaders) for s in syncers],
        "own_blocks": [[b.reference for b in s.core.block_store.get_own_blocks(0, 1 << 30)]
                       for s in syncers],
        "rounds": [s.core.block_store.highest_round() for s in syncers],
        "forged_refs": forged_refs, "forged_stored": stored_forged, **counts,
    }
    for syncer in syncers:
        syncer.core.wal_writer.close()
        syncer.core.block_store.close()  # the WAL reader's mmap and descriptor
    return result


def consensus_run(kind, n, virtual_s, seed, backend=None, metrics=None):
    """One seeded simulation of ``consensus_sim`` in a temporary directory:
    ``kind`` "cuda-only" gives every node a collector over the one shared
    ``backend`` (a ``TorchSignatureVerifier``); "cpu" gives every node the
    ``cpu`` kind's collector (the oracle).  Returns the simulation's result
    with its wall seconds."""
    import tempfile

    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier
    from mysticeti_tpu_torch.runtime.simulated import run_simulation
    from mysticeti_tpu_torch.validator import _make_verifier

    def make_collector(committee):
        if kind == "cpu":
            return _make_verifier("cpu", committee, metrics=metrics)
        check(kind == "cuda-only" and backend is not None, f"no backend for {kind}")
        return BatchedSignatureVerifier(committee, backend, metrics=metrics)

    with tempfile.TemporaryDirectory(prefix="consensus-") as d:
        t0 = time.monotonic()
        result = run_simulation(
            consensus_sim(n, d, virtual_s, make_collector, CONSENSUS_FORGE_ONE_IN), seed=seed)
        result["wall_s"] = time.monotonic() - t0
    return result


def consensus_checks(card, cpu, min_commits) -> dict:
    """Checks 1-4 of the consensus phase on the card run and the ``cpu``
    run of the same seed; returns the readings they share."""
    sequences = card["sequences"]
    commits = [len(seq) for seq in sequences]
    check(min(commits) >= min_commits, f"a node committed fewer than {min_commits} leaders: {commits}")
    longest = max(sequences, key=len)
    for seq in sequences:
        check(seq == longest[: len(seq)], f"the committed sequences fork: {seq} vs {longest}")
    check(card["forged"] > 0, "no forged copy was delivered")
    check(card["forged_rejected"] == card["forged"],
          f"{card['forged'] - card['forged_rejected']} forged copies were accepted")
    check(card["forged_stored"] == 0, "a forged block is in a node's store")
    check(card["honest_rejected"] == 0, f"{card['honest_rejected']} honest blocks were rejected")
    check(card["sequences"] == cpu["sequences"], "the committed sequences differ from the cpu run's")
    check(card["own_blocks"] == cpu["own_blocks"], "the own blocks differ from the cpu run's")
    return {"commits_min": min(commits), "commits_max": max(commits),
            "rounds_min": min(card["rounds"]), "rounds_max": max(card["rounds"]),
            "deliveries": card["deliveries"], "signatures_verified": card["signatures_verified"],
            "forged": card["forged"], "forged_rejected": card["forged_rejected"]}


def consensus_phase(kernels):
    """The consensus-50 cell: the same seeded simulation over the card
    (``cuda-only`` collectors sharing one ``TorchSignatureVerifier`` on
    cuda:0) and over the ``cpu`` kind, with the six checks (see the module
    docstring, step 11)."""
    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.metrics import Metrics

    n, virtual_s, seed = COMMITTEE, CONSENSUS_VIRTUAL_S, SEED
    committee = Committee.new_for_benchmarks(n)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()  # the kernels' first launches and the combs' upload
    metrics = Metrics()
    for k in kernels:
        k.reset_counts()
    card = consensus_run("cuda-only", n, virtual_s, seed, backend=backend, metrics=metrics)
    launches = {k.name: k.launches for k in kernels}
    cpu = consensus_run("cpu", n, virtual_s, seed)
    reading = consensus_checks(card, cpu, CONSENSUS_MIN_COMMITS)
    check(launches["prologue"] > 0 and launches["verify_keyed"] > 0,
          f"the consensus path did not take the prologue and the keyed kernel: {launches}")
    check(launches["verify_generic"] == 0,
          f"the consensus path launched the generic kernel: {launches}")
    get = metrics.registry.get_sample_value
    label = getattr(backend, "backend_label", type(backend).__name__)
    on_card = sum(get("verified_signatures_total", {"backend": label, "outcome": o}) or 0.0
                  for o in ("accepted", "rejected"))
    dispatched = get("verify_dispatch_batch_size_sum") or 0.0
    flushes = get("verify_dispatch_batch_size_count") or 0.0
    check(on_card == dispatched == card["signatures_verified"],
          f"signatures on the card {on_card:.0f}, dispatched {dispatched:.0f}, deliveries "
          f"verified {card['signatures_verified']}")
    stages = {stage: {"sum_s": get("verify_pipeline_stage_seconds_sum", {"stage": stage}),
                      "count": get("verify_pipeline_stage_seconds_count", {"stage": stage})}
              for stage in ("pack", "device", "fetch")}
    reading.update({
        "committee": n, "virtual_s": virtual_s, "seed": seed, "card_wall_s": card["wall_s"],
        "cpu_wall_s": cpu["wall_s"], "deliveries_per_wall_s": card["deliveries"] / card["wall_s"],
        "signatures_on_card": on_card, "flushes": flushes,
        "mean_live_lanes": dispatched / flushes if flushes else 0.0, "stage_seconds": stages,
        "launches": launches, "card": card_line()})
    print(f"consensus: {n} authorities, {virtual_s} virtual s, rounds "
          f"{reading['rounds_min']}-{reading['rounds_max']}, commits a node "
          f"{reading['commits_min']}-{reading['commits_max']}, prefixes agree and equal the cpu "
          f"run's; {card['deliveries']} deliveries ({card['forged']} forged, all rejected) in "
          f"{card['wall_s']:.1f} s on the card ({reading['deliveries_per_wall_s']:.1f}/s), "
          f"{cpu['wall_s']:.1f} s on the cpu kind; {flushes:.0f} flushes, "
          f"{reading['mean_live_lanes']:.2f} live lanes a flush; launches {launches} "
          f"[{reading['card']}]", flush=True)
    return launches, reading


def bench_phase() -> dict:
    """``python -m mysticeti_tpu_torch.bench`` as a child, on BENCH_ENV."""
    env = dict(os.environ, **BENCH_ENV)
    env.pop("BENCH_WORKER", None)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "mysticeti_tpu_torch.bench"], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(lines[-1])
    check(record.get("metric") == "ed25519_verifies_per_sec" and record.get("rung") == 0
          and record.get("value", 0) > 0, f"bench line {lines[-1]}")
    record["seconds"] = time.monotonic() - t0
    record["env"] = BENCH_ENV
    print(json.dumps({"bench": record}), flush=True)
    return record


def build_and_report(K, cuda_build) -> None:
    """Build every kernel source (one nvcc each, in parallel); print the
    build time and ptxas's register, stack and spill lines."""
    t0 = time.monotonic()
    K.build_all()
    units = sorted({k.unit for k in K.KERNELS})
    print(f"build: {time.monotonic() - t0:.1f} s for {len(K.KERNELS)} kernels in {len(units)} "
          f"sources, one nvcc each in parallel", flush=True)
    for name, log in sorted(cuda_build.ptxas_reports.items()):
        for line in log.splitlines():
            if "Used" in line or "stack" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)


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

    from mysticeti_tpu_torch.metrics import Metrics

    print(card_line(), flush=True)
    # The run's registry: attributed from the kernels' build on.
    metrics = Metrics()
    E.install_device_attribution(metrics)
    build_and_report(K, cuda_build)

    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    dev = E.resolve_device(None)
    table = E.KeyTable(committee.public_key_bytes(), device=dev)
    report = {}
    keyed_chunk = kernel_phase(signers, table, rng, report)
    by_path, rates, blocks_and_want, burst, metrics_reading = main_path(
        signers, committee, rng, K.KERNELS, metrics)
    by_path["flat_keyed"], layout = flat_phase(table, keyed_chunk, K.KERNELS, report)
    by_path["sharded"], sharded = sharded_phase(table, burst, rng, K.KERNELS)
    by_path["hybrid"], hybrid = hybrid_phase(committee, blocks_and_want, K.KERNELS)
    by_path["entry"], by_path["dryrun"] = entry_phase(K.KERNELS)
    by_path["service"], service = service_phase(committee, blocks_and_want, K.KERNELS,
                                                rates["block_per_s"])
    by_path["receive"], receive = receive_phase(committee, signers, rng, K.KERNELS)
    by_path["consensus"], consensus = consensus_phase(K.KERNELS)
    bench = bench_phase()
    # The block path's flushes take the keyed kernel, one key per lane, and
    # never the generic one; the committee dispatch's 8 stragglers take the
    # generic kernel once.
    block, burst_counts = by_path["block"], by_path["committee"]
    check(block["prologue"] > 0 and block["verify_keyed"] > 0,
          f"the block path did not take the prologue and the keyed kernel: {block}")
    check(block["verify_generic"] == 0, f"the block path launched the generic kernel: {block}")
    check(burst_counts["verify_keyed"] == 1 and burst_counts["verify_generic"] == 1,
          f"the committee dispatch did not take one keyed and one generic launch: {burst_counts}")
    check(by_path["flat_keyed"]["prologue_flat"] > 0, "prologue_flat was not launched")
    check(by_path["sharded"]["verify_generic"] > 0, "the sharded path launched no kernel")
    check(by_path["hybrid"]["verify_generic"] == 0, "the hybrid block path launched the generic kernel")

    rows = []
    for k in K.KERNELS:
        r = report[k.name]
        check(r["max_abs_err"] == 0, f"{k.name} differs from its plain version")
        rows.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(counts[k.name] for counts in by_path.values()),
            "launches_by_path": {path: counts[k.name] for path, counts in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **{key: r[key] for key in ("field_ops_per_lane", "ms_at_256_lanes", "ms_at_1_lane",
                                       "lane_form_ms", "lane_form_plain_ms",
                                       "bound_ms_plain_formulas", "plain_field_muls_per_lane",
                                       "block_threads", "dynamic_smem_bytes") if key in r},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"e2e_sig_per_s": rates["committee_sig_per_s"], "signatures": KEYED_LANES,
                      "bucket": BUCKET, "committee": COMMITTEE,
                      "block_path_blocks_per_s": rates["block_per_s"], "flush": report["flush"],
                      "flat_vs_26col": layout, "sharded": sharded, "hybrid": hybrid,
                      "service": service, "receive": receive, "consensus": consensus,
                      "metrics": metrics_reading,
                      "bench": bench}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sharded_only() -> int:
    """The sharded phase alone, for a host with several cards (every other
    phase needs only one): ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.sharded_only))'``."""
    import torch

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    table = E.KeyTable(committee.public_key_bytes(), device=E.resolve_device(None))
    lanes = sign_cases(signers, KEYED_LANES, rng, stragglers=STRAGGLERS)
    pks, msgs, sigs, labels = (list(x) for x in zip(*lanes))
    launches, reading = sharded_phase(table, (pks, msgs, sigs, [c == "valid" for c in labels]),
                                      rng, K.KERNELS)
    print(json.dumps({"sharded": reading, "launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def receive_only() -> int:
    """The receive phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.receive_only))'``."""
    import torch

    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    committee = Committee.new_for_benchmarks(COMMITTEE)
    launches, reading = receive_phase(committee, Committee.benchmark_signers(COMMITTEE),
                                      random.Random(SEED), K.KERNELS)
    print(json.dumps({"receive": reading, "launches": launches}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def consensus_only() -> int:
    """The consensus phase alone: ``python3 -c 'import chip_smoke as c;
    raise SystemExit(c.main(c.consensus_only))'``."""
    import torch

    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    launches, reading = consensus_phase(K.KERNELS)
    print(json.dumps({"consensus": reading, "launches": launches}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def offload_decode_times(frames):
    """Seconds to decode ``frames`` natively one frame at a time on the
    data-plane offload worker from memoryview slices of one buffer a frame
    (what ``decode_message`` hands over): keeping every block, as the
    receive path does, and dropping each frame's blocks once decoded.  The
    two split the receive path's decode time into the decode's own work and
    what keeping ~1 GB of new blocks costs."""
    from mysticeti_tpu_torch.core_task import DataPlaneOffload
    from mysticeti_tpu_torch.types import StatementBlock

    def views(frame):
        buf = memoryview(bytearray(b"".join(frame)))
        cuts = [0]
        for raw in frame:
            cuts.append(cuts[-1] + len(raw))
        return [buf[a:b] for a, b in zip(cuts, cuts[1:])]

    async def timed(keep):
        offload = DataPlaneOffload()
        kept = []
        try:
            t0 = time.monotonic()
            for batch in framed_views:
                out = await offload.run("decode", StatementBlock.from_bytes_many, batch)
                if keep:
                    kept.extend(out)
            return time.monotonic() - t0
        finally:
            offload.stop()

    framed_views = [views(f) for f in frames]
    return {"kept_s": asyncio.run(timed(True)), "dropped_s": asyncio.run(timed(False))}


def aggregate_bookkeeping_s(committee, blocks, want):
    """Host seconds of the collector's aggregate bookkeeping on ``blocks``
    alone (``aggregate_verify`` and ``_note_endorsements``, the frontier
    answered from ``want`` with no dispatch), median of 3."""
    from mysticeti_tpu_torch.block_validator import BatchedSignatureVerifier, aggregate_verify

    verdict = {b.reference: ok for b, ok in zip(blocks, want)}

    async def direct(sub):
        return [verdict[b.reference] for b in sub]

    async def once():
        collector = BatchedSignatureVerifier(committee, None, aggregate=True)
        t0 = time.monotonic()
        results = await aggregate_verify(blocks, committee, direct,
                                         prior_endorsers=collector._prior_endorsers,
                                         defer_unresolved=True)
        collector._note_endorsements(blocks, results)
        elapsed = time.monotonic() - t0
        check(results == want, "the aggregate rule disagrees with the oracle")
        return elapsed

    return statistics.median(asyncio.run(once()) for _ in range(3))


def receive_split() -> int:
    """Where the receive burst's time goes, on the host alone (not part of
    the default run): ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.receive_split))'``.  The receive phase's blocks and
    frames; the transfer alone (the frames decoded only once the last is
    in); the decode per frame on the offload worker keeping the blocks and
    dropping them; and the host seconds of the aggregate bookkeeping."""
    from mysticeti_tpu_torch.committee import Committee

    print(card_line(), flush=True)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    raws, valid, _ = build_receive_blocks(committee, signers, random.Random(SEED), RECEIVE_ROUNDS,
                                          RECEIVE_TX)
    frames = frames_under_cap(raws, len(signers))
    blocks, wire_s, transfer_s, after_transfer_s, _ = asyncio.run(
        over_loopback(frames, streaming=False))
    check([b.to_bytes() for b in blocks] == raws, "the held frames differ from the sent ones")
    reading = {"transfer_only_s": transfer_s, "decode_after_transfer_s": after_transfer_s,
               "wire_s": wire_s, "decode_offload": offload_decode_times(frames),
               "aggregate_bookkeeping_s": aggregate_bookkeeping_s(committee, blocks, valid),
               "card": card_line()}
    print(json.dumps({"receive_split": reading}), flush=True)
    return 0


def device_busy(prof) -> dict:
    """The device activity of a ``torch.profiler`` run: the union of its
    kernel and copy intervals in seconds, their count, and the summed
    seconds of the most costly names."""
    from torch.autograd import DeviceType

    def get(event, name):
        value = getattr(event, name)
        return value() if callable(value) else value

    spans, by_name = [], {}
    for event in prof.profiler.kineto_results.events():
        if get(event, "device_type") != DeviceType.CUDA:
            continue
        start, end = get(event, "start_ns"), get(event, "end_ns")
        spans.append((start, end))
        name = get(event, "name")
        by_name[name] = by_name.get(name, 0) + end - start
    busy_ns, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_s": busy_ns / 1e9, "events": len(spans),
            "top_s": {name[:60]: ns / 1e9 for name, ns in top}}


def consensus_trace() -> int:
    """How busy the card is in the consensus-50 cell (not part of the
    default run): ``python3 -c 'import chip_smoke as c; raise
    SystemExit(c.main(c.consensus_trace))'``.  The consensus phase's card
    run twice with one seed: as the phase runs it, and under
    ``torch.profiler`` with device activity only.  Prints both wall times,
    the device's busy seconds from the trace (the union of its kernel and
    copy intervals) and the busy share of each wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mysticeti_tpu_torch.block_validator import TorchSignatureVerifier
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    K.build_all()
    committee = Committee.new_for_benchmarks(COMMITTEE)
    backend = TorchSignatureVerifier(committee_keys=committee.public_key_bytes())
    backend.warmup()
    plain = consensus_run("cuda-only", COMMITTEE, CONSENSUS_VIRTUAL_S, SEED, backend=backend)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = consensus_run("cuda-only", COMMITTEE, CONSENSUS_VIRTUAL_S, SEED, backend=backend)
        torch.cuda.synchronize()
    check(traced["sequences"] == plain["sequences"], "the traced run committed other leaders")
    busy = device_busy(prof)
    check(busy["events"] > 0, "the trace holds no device activity")
    reading = {"virtual_s": CONSENSUS_VIRTUAL_S, "deliveries": plain["deliveries"],
               "wall_s": plain["wall_s"], "traced_wall_s": traced["wall_s"], **busy,
               "busy_share": busy["busy_s"] / plain["wall_s"],
               "busy_share_traced": busy["busy_s"] / traced["wall_s"],
               "torch": torch.__version__, "card": card_line()}
    print(json.dumps({"consensus_trace": reading}), flush=True)
    return 0


def kernel_times(which: str = "all", root=None) -> int:
    """Kernels alone, each held to its plain version and timed at BUCKET,
    FLUSH and 1 lanes, and the device time of one FLUSH-signature committee
    flush: ``python3 chip_smoke.py --times NAMES [ROOT]``, NAMES ``all`` or
    a comma-separated list of TIMED.  ROOT, a directory inside this checkout
    (an unpacked earlier commit), holds a port that is imported instead of
    this one's, so two versions can be timed in turns in one call; a part
    that port lacks (the keyed lane form before it existed) is null."""
    import numpy as np
    import torch

    names = TIMED if which == "all" else tuple(which.split(","))
    if not set(names) <= set(TIMED):
        print(f"chip_smoke: --times takes 'all' or names from {TIMED}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.realpath(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.realpath(root or here)
    if os.path.commonpath([root, here]) != here:
        print(f"chip_smoke: {root} is not inside {here}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from mysticeti_tpu_torch.committee import Committee
    from mysticeti_tpu_torch.ops import cuda_build
    from mysticeti_tpu_torch.ops import ed25519 as E
    from mysticeti_tpu_torch.ops import ed25519_cuda as K

    print(card_line(), flush=True)
    build_and_report(K, cuda_build)
    rng = random.Random(SEED)
    committee = Committee.new_for_benchmarks(COMMITTEE)
    signers = Committee.benchmark_signers(COMMITTEE)
    dev = E.resolve_device(None)
    table = E.KeyTable(committee.public_key_bytes(), device=dev)
    pks, msgs, sigs, labels = shuffled_lanes(signers, rng)
    expected = np.array([c == "valid" for c in labels])
    indexed = E.to_device_words(
        E.pack_blob_indexed(table.indices_for(pks), msgs, sigs, num_keys=len(table)), dev)
    times = {}
    if "prologue" in names:
        times["prologue"] = prologue_readings(indexed, table.words)
    if "verify_generic" in names:
        k_raw = K.prologue(E.to_device_words(E.pack_blob(pks, msgs, sigs), dev))
        times["verify_generic"] = generic_readings(k_raw, expected)
    if "verify_keyed" in names:
        times["verify_keyed"] = keyed_tile_readings(table, pks, msgs, sigs, expected)[0]
    if "verify_keyed_lanes" in names:
        times["verify_keyed_lanes"] = (keyed_lane_readings(table, indexed, expected)
                                       if hasattr(K, "verify_keyed_lanes") else None)
    if "flush" in names:
        times["flush"] = flush_reading(table, pks, msgs, sigs, expected, K.KERNELS)
    for name, r in times.items():
        check(r is None or r.get("max_abs_err", 0) == 0, f"{name} differs from its plain version")
    print(json.dumps({"times": times, "package": os.path.dirname(E.__file__),
                      "card": card_line()}), flush=True)
    return 0


def main(entry=run, *args) -> int:
    try:
        return entry(*args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--times"]:
        sys.exit(main(kernel_times, *sys.argv[2:4]))
    sys.exit(main())
