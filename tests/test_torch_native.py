"""The port's native data plane against the JAX package's.

Every function of the port's extension (``mysticeti_tpu_torch/native``, built
with g++ at first import from the port's own copy of the C++ source) is held
to the JAX package's ``_native`` on the same seeded inputs: ``wal_scan`` on
torn and corrupt buffers, ``frame_entry``, ``block_digests`` (also to
``hashlib``, on frames that fan out over several threads and frames that do
not, with the frame counts it keeps), ``encode_blocks_frame``,
``split_frames``, ``parse_blocks_spans`` (with the error text of torn
frames), a ``va_*`` vote sequence and ``decode_block``.
Then ``StatementBlock.from_bytes_many`` of the port (native, forced onto the
per-raw fallback in process, and with ``MYSTICETI_NO_NATIVE=1`` in a child)
against the JAX package's on a corpus with malformed entries, and the
native and pure-Python decoders of the port against each other on mutated
frames.  Last, the loader: the build-failure marker, the no-toolchain and
``MYSTICETI_NO_NATIVE`` cases and ``active_functions()``.  Every comparison
is exact: the outputs are bytes, integers and error strings.
"""
import hashlib
import json
import os
import pathlib
import random
import struct
import subprocess
import sys
import threading
import zlib

import pytest

import mysticeti_tpu.types as JT
from mysticeti_tpu.committee import Committee as JCommittee
from mysticeti_tpu.native import native as jnative
from mysticeti_tpu.wal import WAL_MAGIC

import mysticeti_tpu_torch.native as native_pkg
import mysticeti_tpu_torch.types as PT
from mysticeti_tpu_torch.committee import Committee
from mysticeti_tpu_torch.metrics import Metrics
from mysticeti_tpu_torch.native import active_functions, native
from mysticeti_tpu_torch.serde import SerdeError

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIGNERS = Committee.benchmark_signers(4)
GENESIS = [PT.StatementBlock.new_genesis(i).reference for i in range(4)]
RECEIVE_PATH = {"decode_block", "decode_register", "block_digests", "encode_blocks_frame",
                "split_frames", "parse_blocks_spans"}


def test_both_extensions_are_built_and_distinct():
    """The port loads its own build, from its own directory; the JAX
    package's extension is there to compare with."""
    assert native is not None and jnative is not None
    assert native is not jnative
    assert pathlib.Path(native.__file__).parent == ROOT / "mysticeti_tpu_torch" / "native"
    assert native.__name__ == "mysticeti_tpu_torch.native._native"


def _entry(tag, payload):
    return struct.pack("<IIII", WAL_MAGIC, zlib.crc32(payload), len(payload), tag) + payload


def test_wal_scan_equals_the_jax_package_on_torn_and_corrupt_buffers():
    rng = random.Random(0x3A1)
    for _ in range(40):
        entries = [_entry(rng.randrange(1, 9), rng.randbytes(rng.choice((0, 1, 5, 300, 4000))))
                   for _ in range(rng.randrange(0, 8))]
        buf = bytearray(b"".join(entries))
        mode = rng.choice(("whole", "torn", "flip", "magic"))
        if buf and mode == "torn":
            buf = buf[: rng.randrange(len(buf))]
        elif buf and mode == "flip":
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        elif mode == "magic":
            buf = bytearray(16) + buf
        buf = bytes(buf)
        for end in {len(buf), len(buf) // 2, 0}:
            assert native.wal_scan(buf, end) == jnative.wal_scan(buf, end)
    good = _entry(1, b"alpha")
    torn = _entry(2, b"beta")[:-2]
    assert len(native.wal_scan(good + torn, len(good) + len(torn))) == 1
    assert native.wal_scan(b"\x00" * 32, 32) == []


def test_frame_entry_equals_the_jax_package():
    rng = random.Random(0xF7)
    for _ in range(30):
        parts = [rng.randbytes(rng.choice((0, 1, 17, 999))) for _ in range(rng.randrange(0, 5))]
        tag = rng.randrange(0, 2**32)
        got = native.frame_entry(tag, parts)
        assert got == jnative.frame_entry(tag, parts) == _entry(tag, b"".join(parts))


def test_block_digests_equal_the_jax_package():
    rng = random.Random(0xD1)
    parts = [rng.randbytes(n) for n in (0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 1024)]
    parts += [rng.randbytes(rng.randrange(0, 5000)) for _ in range(20)]
    assert native.block_digests(parts) == jnative.block_digests(parts)
    assert native.block_digests([memoryview(p) for p in parts]) == jnative.block_digests(parts)
    assert native.block_digests([]) == []


KIB = 1024
MIB = 1024 * KIB
# Part sizes of one block_digests call: frames under the fan-out threshold
# (1 MiB a thread) and frames over it, uneven sizes in one frame, one block,
# two, and more blocks than threads.
DIGEST_FRAMES = {
    "small-serial": [0, 1, 63, 64, 65, 127, 128, 129, 4000, 10 * KIB],
    "uneven-serial": [0, 63, 64, 129, 300 * KIB, MIB + 1],
    "uneven-fanned": [0, 63, 64, 129, 300 * KIB, MIB + 1, 3 * MIB],
    "one-large-block": [4 * MIB],
    "two-blocks": [MIB + 300 * KIB, MIB + 600 * KIB],
    "more-blocks-than-threads": [300 * KIB + i for i in range(15)],
    "large-then-tiny": [2 * MIB] + [64 * i for i in range(20)],
}
BALANCED_FRAMES = {"two-blocks", "more-blocks-than-threads"}


def _hashlib_digests(part):
    part = bytes(part)
    return (hashlib.blake2b(part, digest_size=32).digest(),
            hashlib.blake2b(part[:-64], digest_size=32).digest())


def _expected_threads(sizes):
    """The fan-out rule: min(half the affinity mask's CPUs, at most 4;
    bytes / 1 MiB; blocks), at least 1."""
    cap = max(1, min(4, len(os.sched_getaffinity(0)) // 2))
    return max(1, min(cap, sum(sizes) // MIB, len(sizes)))


def _digest_frames(metrics):
    get = metrics.registry.get_sample_value
    return {t: get("dataplane_digest_frames_total", {"threads": str(t)}) or 0.0
            for t in range(1, 5)}


@pytest.mark.parametrize("kind", ["bytes", "memoryview"])
@pytest.mark.parametrize("frame", sorted(DIGEST_FRAMES))
def test_block_digests_equal_hashlib_and_the_jax_package(frame, kind):
    """Each part's digest and signed pre-hash, in the parts' order, equal
    ``hashlib``'s blake2b-256 of the whole part and of ``part[:-64]``, and
    the JAX package's serial ``block_digests``, however many threads hashed
    the frame; the frame counts once, under the thread count the rule gives
    where no block outweighs a thread's share of the bytes."""
    rng = random.Random(zlib.crc32(frame.encode()))
    sizes = DIGEST_FRAMES[frame]
    raws = [rng.randbytes(n) for n in sizes]
    parts = raws if kind == "bytes" else [memoryview(r) for r in raws]
    metrics = Metrics()
    before = _digest_frames(metrics)
    got = native.block_digests(parts)
    after = _digest_frames(metrics)
    assert got == [_hashlib_digests(r) for r in raws]
    assert got == jnative.block_digests(raws)
    counted = [t for t in after if after[t] != before[t]]
    assert len(counted) == 1 and after[counted[0]] - before[counted[0]] == 1
    # The ranges split the bytes, so a block larger than a thread's share
    # leaves fewer ranges, and threads, than the rule allows.
    threads = _expected_threads(sizes)
    if threads == 1 or frame in BALANCED_FRAMES:
        assert counted == [threads]
    else:
        assert 1 < counted[0] <= threads


def test_block_digests_type_error_mid_frame_releases_every_buffer():
    """A non-buffer item in the middle of a frame large enough to fan out
    raises TypeError, and every buffer taken before it is released: the
    bytearray parts of the same call, first and right before the bad item,
    can still be resized."""
    rng = random.Random(3)
    first, last = bytearray(rng.randbytes(600 * KIB)), bytearray(rng.randbytes(KIB))
    parts = [first, bytes(MIB), last, 12345, bytes(MIB)]
    with pytest.raises(TypeError):
        native.block_digests(parts)
    for grown, size in ((first, 600 * KIB), (last, KIB)):
        grown.extend(b"more")  # raises BufferError if an export leaked
        del grown[:10]
        assert len(grown) == size - 6


def test_digest_frame_counter_counts_fanned_and_serial_frames():
    """``dataplane_digest_frames_total``: a 4-MiB frame of eight blocks
    counts under the fan-out's thread count (more than one wherever the
    process may run on four CPUs or more), a 10-KiB frame under
    ``threads="1"``, an empty call nowhere."""
    metrics = Metrics()
    large = [bytes(512 * KIB)] * 8
    threads = _expected_threads([len(p) for p in large])
    assert threads > 1 or len(os.sched_getaffinity(0)) < 4
    before = _digest_frames(metrics)
    native.block_digests(large)
    mid = _digest_frames(metrics)
    native.block_digests([bytes(10 * KIB)])
    native.block_digests([])
    after = _digest_frames(metrics)
    assert {t: mid[t] - before[t] for t in mid} == {t: float(t == threads) for t in mid}
    assert {t: after[t] - mid[t] for t in mid} == {t: float(t == 1) for t in mid}


def test_block_digests_from_many_threads_at_once():
    """Eight Python threads call ``block_digests`` on fanned frames at once
    under a short switch interval: every result is hashlib's, and the frame
    counts rise by exactly the number of calls (no lost update)."""
    rng = random.Random(8)
    frames = [[rng.randbytes(MIB + i) for i in range(4)] for _ in range(8)]
    want = [[_hashlib_digests(p) for p in frame] for frame in frames]
    calls = 5
    metrics = Metrics()
    before = sum(_digest_frames(metrics).values())
    results = [[] for _ in frames]

    def work(i):
        for _ in range(calls):
            results[i].append(native.block_digests(frames[i]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert results == [[w] * calls for w in want]
    assert sum(_digest_frames(metrics).values()) - before == len(frames) * calls


BLOCKS_SHAPES = [
    (2, False, 0, 0, (b"block-one", b"block-two-bytes")),
    (2, False, 0, 0, ()),
    (2, False, 0, 0, (b"",)),
    (4, False, 0, 0, (b"resp", b"", b"x" * 300)),
    (12, True, 111, 222, (b"stamped-block",)),
    (12, True, 2**64 - 1, 0, (b"", b"a")),
]


def _shapes(seed):
    rng = random.Random(seed)
    out = list(BLOCKS_SHAPES)
    for _ in range(25):
        tag, stamped = rng.choice([(2, False), (4, False), (12, True)])
        out.append((tag, stamped, rng.randrange(2**64) if stamped else 0,
                    rng.randrange(2**64) if stamped else 0,
                    tuple(rng.randbytes(rng.choice((0, 1, 7, 64, 200))) for _ in range(rng.randrange(0, 8)))))
    return out


def test_encode_blocks_frame_equals_the_jax_package():
    for shape in _shapes(0x19):
        got = native.encode_blocks_frame(*shape)
        assert got == jnative.encode_blocks_frame(*shape)
        views = shape[:4] + (tuple(memoryview(p) for p in shape[4]),)
        assert native.encode_blocks_frame(*views) == got


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("err", str(exc))


def test_parse_blocks_spans_equals_the_jax_package_with_torn_frames():
    for shape in _shapes(0x5B):
        payload = jnative.encode_blocks_frame(*shape)
        assert native.parse_blocks_spans(payload) == jnative.parse_blocks_spans(payload)
        for cut in range(1, len(payload)):
            got = _outcome(native.parse_blocks_spans, payload[:cut])
            assert got[0] == "err" and got == _outcome(jnative.parse_blocks_spans, payload[:cut])
        got = _outcome(native.parse_blocks_spans, payload + b"\x00")
        assert got == ("err", "trailing garbage: 1 bytes")
    for tag in (1, 3, 5, 6, 13, 17, 200):
        frame = bytes([tag]) + b"\x00" * 8
        assert _outcome(native.parse_blocks_spans, frame) == \
            _outcome(jnative.parse_blocks_spans, frame) == \
            ("err", f"not a blocks-shaped frame: tag {tag}")


def test_split_frames_equals_the_jax_package():
    rng = random.Random(0x5F)
    payloads = [rng.randbytes(rng.choice((0, 1, 9, 300))) for _ in range(12)]
    stream = b"".join(len(p).to_bytes(4, "little") + p for p in payloads)
    buf = bytearray(stream) + bytearray(8)
    for cut in range(len(stream) + 1):
        assert native.split_frames(buf, 0, cut, 1 << 24) == jnative.split_frames(buf, 0, cut, 1 << 24)
    for start in (1, 5, 13):
        shifted = bytearray(b"\xee" * start) + bytearray(stream)
        assert native.split_frames(shifted, start, len(shifted), 1 << 24) == \
            jnative.split_frames(shifted, start, len(shifted), 1 << 24)
    first = len(payloads[0]) + 4
    evil = bytearray(stream[:first] + (2**24 + 1).to_bytes(4, "little") + b"boom")
    got = native.split_frames(evil, 0, len(evil), 1 << 24)
    assert got == jnative.split_frames(evil, 0, len(evil), 1 << 24) and got[2] == 2**24 + 1


def _va_run(mod, seed):
    """A seeded vote sequence through the vote-aggregator core: registers,
    votes (overlapping, unknown, duplicate), processed probes, snapshots and
    a load into a second core; returns every output in order."""
    rng = random.Random(seed)
    n = 7
    out = []
    for track, kind in ((True, 0), (False, 1)):
        h = mod.va_new(track, kind)
        stakes = [rng.randint(1, 3) for _ in range(n)]
        mod.va_bind(h, stakes, (2 * sum(stakes)) // 3 + 1 if kind == 0 else sum(stakes) // 3 + 1)
        keys = [struct.pack("<QQ", a, r) + rng.randbytes(32) for a in range(3) for r in (1, 2)]
        for i, key in enumerate(keys):
            out.append(("reg", mod.va_register(h, key, 0, 30, i % n)))
        for _ in range(120):
            key = rng.choice(keys)
            s = rng.randrange(0, 40)
            e = s + rng.randrange(0, 20)
            vote = rng.randrange(n)
            if rng.random() < 0.3:
                out.append(("reg", mod.va_register(h, key, s, e, vote)))
            else:
                out.append(("vote", mod.va_vote(h, key, s, e, vote)))
            out.append(("proc", mod.va_is_processed(h, key, rng.randrange(0, 60))))
        out.append(("len", mod.va_pending_len(h)))
        items = mod.va_items(h)
        out.append(("items", items))
        out.append(("state", mod.va_state(h)))
        h2 = mod.va_new(track, kind)
        mod.va_bind(h2, stakes, 1)
        for key, ranges in items:
            for s, e, stake, k, mask in ranges:
                mod.va_load(h2, key, s, e, stake, k, mask)
        out.append(("loaded", mod.va_items(h2)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_vote_aggregator_sequence_equals_the_jax_package(seed):
    got = _va_run(native, seed)
    assert got == _va_run(jnative, seed)
    assert any(kind == "vote" and res[0] for kind, res in got)  # something certified


# -- decode: the port's from_bytes / from_bytes_many against the JAX package --

def _mutations(raw, rng):
    out = [raw, raw[: len(raw) // 2], raw + b"\x00\x01", b""]
    for _ in range(6):
        flipped = bytearray(raw)
        flipped[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        out.append(bytes(flipped))
    return out


def _corpus(seed=0xB10C):
    """Serialized blocks with every statement kind, and malformed entries."""
    rng = random.Random(seed)
    signers = JCommittee.benchmark_signers(4)
    genesis = [JT.StatementBlock.new_genesis(i).reference for i in range(4)]
    raws = []
    for i in range(8):
        statements = []
        for _ in range(rng.randrange(0, 7)):
            ref = JT.BlockReference(rng.randrange(4), rng.randrange(1, 50), rng.randbytes(32))
            loc = JT.TransactionLocator(ref, rng.randrange(1000))
            kind = rng.randrange(4)
            if kind == 0:
                statements.append(JT.Share(rng.randbytes(rng.randrange(0, 120))))
            elif kind == 1:
                statements.append(JT.Vote(loc, True, None))
            elif kind == 2:
                statements.append(JT.Vote(loc, False, loc if rng.random() < 0.5 else None))
            else:
                s = rng.randrange(500)
                statements.append(JT.VoteRange(JT.TransactionLocatorRange(ref, s, s + rng.randrange(500))))
        block = JT.StatementBlock.build(i % 4, 3 + i, genesis, statements, signer=signers[i % 4])
        raws.extend(_mutations(block.to_bytes(), rng) if i % 3 == 0 else [block.to_bytes()])
    return raws


def _view(block):
    """What a decoded block carries, in package-neutral form."""
    if block is None:
        return None
    ref = block.reference
    return (ref.authority, ref.round, ref.digest.hex(), [repr(r) for r in block.includes],
            [repr(s) for s in block.statements], block.meta_creation_time_ns, block.epoch_marker,
            block.epoch, block.signature.hex(), block.to_bytes().hex(), block.signed_digest().hex(),
            block.shared_transaction_stamps().hex())


def test_from_bytes_many_equals_the_jax_package():
    raws = _corpus()
    raws = [memoryview(r) if i % 3 == 0 else r for i, r in enumerate(raws)]
    got = PT.StatementBlock.from_bytes_many(raws)
    want = JT.StatementBlock.from_bytes_many(raws)
    assert [_view(b) for b in got] == [_view(b) for b in want]
    assert None in got and sum(b is not None for b in got) > 8
    for block in got:
        if block is not None:
            # The batched native path precomputed what verify re-derives.
            assert block._signed_digest is not None and block._stamps is not None
            assert block._share_runs == JT.StatementBlock.from_bytes(block.to_bytes())._share_runs


def test_from_bytes_many_forced_fallback_equals_native(monkeypatch):
    raws = _corpus(7)
    native_out = PT.StatementBlock.from_bytes_many(raws)
    with monkeypatch.context() as m:
        m.setattr(PT, "_native_decode", None)
        m.setattr(PT, "_native_block_digests", None)
        pure_out = PT.StatementBlock.from_bytes_many(raws)
    assert [_view(b) for b in native_out] == [_view(b) for b in pure_out]
    assert all(b is None or b._stamps is None for b in pure_out)


_CHILD = """
import json, sys
from mysticeti_tpu_torch import native as N
from mysticeti_tpu_torch import types as T
raws = [bytes.fromhex(h) for h in json.load(sys.stdin)]
out = T.StatementBlock.from_bytes_many(raws)
print(json.dumps({"native": N.native is None, "active": list(N.active_functions()),
                  "blocks": [None if b is None else [b.reference.digest.hex(),
                             b.signed_digest().hex(), b.to_bytes().hex()] for b in out]}))
"""


def test_no_native_env_pins_the_fallback_in_a_fresh_process():
    raws = _corpus(11)
    env = dict(os.environ, MYSTICETI_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", _CHILD], input=json.dumps([r.hex() for r in raws]),
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    child = json.loads(proc.stdout)
    assert child["native"] is True and child["active"] == []
    want = [None if b is None else [b.reference.digest.hex(), b.signed_digest().hex(),
                                    b.to_bytes().hex()]
            for b in PT.StatementBlock.from_bytes_many(raws)]
    assert child["blocks"] == want


def test_native_and_python_decoders_agree_on_mutated_frames(monkeypatch):
    rng = random.Random(0xC0DE)
    raws = []
    for raw in _corpus(3):
        raws.append(raw)
        for _ in range(4):
            m = bytearray(raw)
            if m and rng.random() < 0.5:
                m[rng.randrange(len(m))] ^= 1 << rng.randrange(8)
            else:
                m = m[: rng.randrange(len(m) + 1)]
            raws.append(bytes(m))

    def decode(raw):
        try:
            return ("ok", _view(PT.StatementBlock.from_bytes(raw)))
        except (SerdeError, ValueError, OverflowError) as exc:
            return ("err", type(exc).__name__)

    native_side = [decode(r) for r in raws]
    monkeypatch.setattr(PT, "_native_decode", None)
    assert native_side == [decode(r) for r in raws]
    assert {kind for kind, _ in native_side} == {"ok", "err"}


def test_forged_huge_counts_rejected_by_both_decoders(monkeypatch):
    frames = [struct.pack("<QQI", 0, 1, 0xFFFFFFFF) + b"\0" * 4,
              struct.pack("<QQI", 0, 1, 0) + struct.pack("<I", 0xFFFFFFFF)]
    for frame in frames:
        with pytest.raises(SerdeError):
            PT.StatementBlock.from_bytes(frame)
    monkeypatch.setattr(PT, "_native_decode", None)
    for frame in frames:
        with pytest.raises(SerdeError):
            PT.StatementBlock.from_bytes(frame)


def test_decoder_stamps_match_the_python_walk():
    rng = random.Random(5)
    for _ in range(20):
        payloads = [rng.randbytes(rng.randrange(0, 24)) for _ in range(rng.randrange(0, 10))]
        built = PT.StatementBlock.build(0, 3, GENESIS, [PT.Share(p) for p in payloads],
                                        signer=SIGNERS[0])
        decoded = PT.StatementBlock.from_bytes(built.to_bytes())
        assert decoded._stamps is not None and built._stamps is None
        assert decoded.shared_transaction_stamps() == built.shared_transaction_stamps() == \
            b"".join(p[:8] if len(p) >= 8 else b"\x00" * 8 for p in payloads)


# -- the loader --

def test_build_failure_marker_roundtrip(tmp_path, monkeypatch):
    marker = tmp_path / "_native.buildfail"
    monkeypatch.setattr(native_pkg, "_FAIL_MARKER", str(marker))
    assert native_pkg._read_marker() == ""
    native_pkg._write_marker("abc123")
    assert native_pkg._read_marker() == "abc123"
    native_pkg._clear_marker()
    assert native_pkg._read_marker() == ""
    native_pkg._clear_marker()  # idempotent on a missing marker


def test_build_writes_marker_when_toolchain_missing(tmp_path, monkeypatch):
    marker = tmp_path / "_native.buildfail"
    monkeypatch.setattr(native_pkg, "_FAIL_MARKER", str(marker))
    monkeypatch.setattr(native_pkg.shutil, "which", lambda _name: None)
    assert native_pkg._build("deadbeef") is False
    assert native_pkg._read_marker() == "deadbeef"


def test_load_skips_rebuild_when_marker_matches(tmp_path, monkeypatch):
    """A source whose build already failed does NOT re-invoke g++ on the
    next boot; editing the source (new fingerprint) re-arms the build."""
    src = tmp_path / "mysticeti_native.cpp"
    src.write_text("int main() { return 1; }\n")
    monkeypatch.setattr(native_pkg, "_SRC", str(src))
    monkeypatch.setattr(native_pkg, "_SO", str(tmp_path / "_native.so"))
    monkeypatch.setattr(native_pkg, "_FAIL_MARKER", str(tmp_path / "_native.buildfail"))
    monkeypatch.delenv("MYSTICETI_NO_NATIVE", raising=False)
    calls = []

    def fake_build(fingerprint=""):
        calls.append(fingerprint)
        native_pkg._write_marker(fingerprint)
        return False

    monkeypatch.setattr(native_pkg, "_build", fake_build)
    assert native_pkg._load() is None
    assert calls == [native_pkg._src_fingerprint()]
    assert native_pkg._load() is None
    assert len(calls) == 1
    src.write_text("int main() { return 2; }\n")
    assert native_pkg._load() is None
    assert len(calls) == 2


def test_build_compiles_the_port_source_into_a_given_place(tmp_path, monkeypatch):
    """``_build`` compiles the port's own source with g++ and zlib, renames
    the result into place atomically and clears a stale marker."""
    monkeypatch.setattr(native_pkg, "_DIR", str(tmp_path))
    monkeypatch.setattr(native_pkg, "_SO", str(tmp_path / "_native.so"))
    monkeypatch.setattr(native_pkg, "_FAIL_MARKER", str(tmp_path / "_native.buildfail"))
    native_pkg._write_marker("stale")
    assert native_pkg._build(native_pkg._src_fingerprint()) is True
    assert (tmp_path / "_native.so").stat().st_size > 0
    assert native_pkg._read_marker() == ""
    assert [p.name for p in tmp_path.iterdir()] == ["_native.so"]


def test_no_native_env_disables_load(monkeypatch):
    monkeypatch.setenv("MYSTICETI_NO_NATIVE", "1")
    assert native_pkg._load() is None


def test_active_functions_inventory():
    fns = active_functions()
    assert list(fns) == sorted(fns)
    assert set(fns) == {name for name in dir(jnative) if not name.startswith("_")
                        and callable(getattr(jnative, name))}
    assert RECEIVE_PATH | {"wal_scan", "frame_entry", "va_vote"} <= set(fns)


def test_native_active_metric():
    metrics = Metrics()
    get = metrics.registry.get_sample_value
    assert get("mysticeti_native_active", {"fn": "any"}) == 1
    for fn in active_functions():
        assert get("mysticeti_native_active", {"fn": fn}) == 1


def test_gitignore_keeps_the_build_out_of_the_tree():
    ignore = (ROOT / "mysticeti_tpu_torch" / "native" / ".gitignore").read_text().split()
    assert {"_native.so", "_native.buildfail"} <= set(ignore)


# -- the data-plane offload (core_task.DataPlaneOffload) --

def test_offload_inactive_without_native_or_under_sim(monkeypatch):
    from mysticeti_tpu_torch import runtime
    from mysticeti_tpu_torch.core_task import DataPlaneOffload

    assert runtime.is_simulated() is False  # the port has no deterministic loop yet
    off = DataPlaneOffload()
    assert off.active() is True
    assert off.should_offload(DataPlaneOffload.MIN_BATCH_BYTES)
    assert not off.should_offload(DataPlaneOffload.MIN_BATCH_BYTES - 1)
    monkeypatch.setattr(runtime, "is_simulated", lambda: True)
    assert DataPlaneOffload().active() is False
    monkeypatch.setattr(runtime, "is_simulated", lambda: False)
    monkeypatch.setattr(native_pkg, "native", None)
    assert DataPlaneOffload().should_offload(10**9) is False
    off.stop()


def test_offload_decodes_a_frame_on_its_worker_and_records_the_stage():
    import asyncio
    import threading

    from mysticeti_tpu_torch.core_task import DataPlaneOffload

    raws = _corpus(13)
    metrics = Metrics()
    off = DataPlaneOffload(metrics=metrics)
    seen = {}

    def decode(batch):
        seen["thread"] = threading.current_thread().name
        return PT.StatementBlock.from_bytes_many(batch)

    async def go():
        return await off.run("decode", decode, raws)

    try:
        got = asyncio.run(go())
    finally:
        off.stop()
    assert seen["thread"].startswith("dataplane-offload")
    assert [_view(b) for b in got] == [_view(b) for b in PT.StatementBlock.from_bytes_many(raws)]
    get = metrics.registry.get_sample_value
    assert get("dataplane_offload_seconds_count", {"stage": "decode"}) == 1
    assert get("utilization_timer_total", {"proc": "offload:decode"}) is not None
