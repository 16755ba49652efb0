"""The DAG data model: statement blocks, references, statements, authority bitsets.

Capability parity with ``mysticeti-core/src/types.rs``:

* ``BlockReference`` {authority, round, digest}  (types.rs:50-54)
* ``BaseStatement``: Share(tx) | Vote(locator, vote) | VoteRange(range)  (types.rs:57-64)
* ``StatementBlock`` with ordered includes (first include of an (authority, round) pair is
  the one the block conceptually votes for), meta creation time, epoch marker/number, and
  author signature  (types.rs:93-114)
* ``AuthoritySet`` — a 512-bit bitset bounding committee size  (types.rs:116-121)
* ``StatementBlock.verify`` — the consensus-rule verification entry  (types.rs:315-376)
* ``TransactionLocator`` / ``TransactionLocatorRange``  (types.rs:383-394)

The port's copy of ``mysticeti_tpu.types``, with the native C++ decoder
(``native/``) behind ``from_bytes`` and the batched ``from_bytes_many``, and
the pure-Python decoder as the fallback, and the simulator's decode memo.

Design notes: blocks are immutable and cache their canonical
serialization at construction, so digesting / signing / wire framing never re-encode
(the role of ``Data<T>`` in data.rs:22-44).  Signature-covered bytes and digest-covered
bytes are the same encoding with/without the trailing signature field, preserving the
reference's layering trick (crypto.rs:77-84) that batch verification relies on.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from . import crypto
from .serde import Reader, SerdeError, Writer

# Structs for the inline block decoder (from_bytes fast path).
_U64X2 = struct.Struct("<QQ")
_U64_AT = struct.Struct("<Q")
_U32_AT = struct.Struct("<I")

AuthorityIndex = int  # u64 in encodings
RoundNumber = int
Epoch = int

GENESIS_ROUND = 0
MAX_COMMITTEE_SIZE = 512

# Epoch marker carried in each block: has this authority begun epoch change?
EPOCH_OPEN = 0
EPOCH_CHANGED = 1


@dataclass(frozen=True, order=True)
class BlockReference:
    """(authority, round, digest) triple naming a block (types.rs:50-54)."""

    authority: AuthorityIndex
    round: RoundNumber
    digest: bytes  # 32 bytes

    def author_round(self) -> Tuple[AuthorityIndex, RoundNumber]:
        return (self.authority, self.round)

    def encode(self, w: Writer) -> None:
        w.u64(self.authority).u64(self.round).fixed(self.digest)

    @staticmethod
    def decode(r: Reader) -> "BlockReference":
        return BlockReference(r.u64(), r.u64(), r.fixed(crypto.DIGEST_SIZE))

    def __repr__(self) -> str:
        return f"{chr(ord('A') + self.authority % 26)}{self.round}"


@dataclass(frozen=True, order=True)
class TransactionLocator:
    """Names one transaction: the block that shared it + statement offset (types.rs:383-387)."""

    block: BlockReference
    offset: int

    def encode(self, w: Writer) -> None:
        self.block.encode(w)
        w.u64(self.offset)

    @staticmethod
    def decode(r: Reader) -> "TransactionLocator":
        return TransactionLocator(BlockReference.decode(r), r.u64())


# Upper bound on vote-range extent; a Byzantine block must not be able to make a
# validator iterate an unbounded range (reference caps at 1M, types.rs range verify).
LOCATOR_RANGE_MAX_LEN = 1 << 20


@dataclass(frozen=True, order=True)
class TransactionLocatorRange:
    """Half-open offset range of transactions within one block (types.rs:389-394)."""

    block: BlockReference
    offset_start_inclusive: int
    offset_end_exclusive: int

    def verify(self) -> None:
        if self.offset_end_exclusive < self.offset_start_inclusive:
            raise SerdeError(
                f"invalid locator range: end {self.offset_end_exclusive} < "
                f"start {self.offset_start_inclusive}"
            )
        # direct arithmetic: __len__ cannot represent >ssize_t ranges
        if self.offset_end_exclusive - self.offset_start_inclusive > LOCATOR_RANGE_MAX_LEN:
            raise SerdeError(
                f"locator range too long: "
                f"{self.offset_end_exclusive - self.offset_start_inclusive}"
            )
        if self.offset_end_exclusive > LOCATOR_RANGE_MAX_LEN:
            raise SerdeError(
                f"locator range end too large: {self.offset_end_exclusive}"
            )

    def locators(self) -> Iterator[TransactionLocator]:
        for off in range(self.offset_start_inclusive, self.offset_end_exclusive):
            yield TransactionLocator(self.block, off)

    def __len__(self) -> int:
        return max(0, self.offset_end_exclusive - self.offset_start_inclusive)

    def encode(self, w: Writer) -> None:
        self.block.encode(w)
        w.u64(self.offset_start_inclusive).u64(self.offset_end_exclusive)

    @staticmethod
    def decode(r: Reader) -> "TransactionLocatorRange":
        return TransactionLocatorRange(BlockReference.decode(r), r.u64(), r.u64())


# --- Statements -------------------------------------------------------------------

VOTE_ACCEPT = 0
VOTE_REJECT = 1

_ST_SHARE = 0
_ST_VOTE = 1
_ST_VOTE_RANGE = 2


@dataclass(frozen=True)
class Share:
    """Authority shares a transaction without voting on it (types.rs:57-59)."""

    transaction: bytes


@dataclass(frozen=True)
class Vote:
    """Authority votes to accept or reject a transaction (types.rs:30-34,60-61).

    ``conflict`` (the competing locator of a Reject) is only meaningful on reject
    votes; carrying one on an accept would be silently unencodable."""

    locator: TransactionLocator
    accept: bool = True
    conflict: Optional[TransactionLocator] = None  # Reject(Option<locator>)

    def __post_init__(self) -> None:
        if self.accept and self.conflict is not None:
            raise ValueError("accept votes cannot carry a conflict locator")


@dataclass(frozen=True)
class VoteRange:
    """Batched accept votes over a contiguous locator range (types.rs:62-63)."""

    range: TransactionLocatorRange


BaseStatement = object  # Share | Vote | VoteRange


def encode_statements(w: Writer, statements: Sequence[BaseStatement]) -> None:
    """Encode a statement sequence with the Share hot path inlined: a
    saturated proposer encodes ~10k Shares per block (and each statement is
    encoded twice — pending-payload WAL entry, then the proposal), so the
    per-call Writer dispatch was a measurable interpreter cost.  Bytes are
    identical to per-statement ``encode_statement`` (round-trip property
    tests pin canonicality)."""
    buf = w.buf
    pack_len = _U32_AT.pack
    share_tag = bytes([_ST_SHARE])
    for st in statements:
        if type(st) is Share:
            t = st.transaction
            buf += share_tag
            buf += pack_len(len(t))
            buf += t
        else:
            encode_statement(w, st)


def encode_statement(w: Writer, st: BaseStatement) -> None:
    if isinstance(st, Share):
        w.u8(_ST_SHARE).bytes(st.transaction)
    elif isinstance(st, Vote):
        w.u8(_ST_VOTE)
        st.locator.encode(w)
        w.u8(VOTE_ACCEPT if st.accept else VOTE_REJECT)
        if not st.accept:
            w.u8(1 if st.conflict is not None else 0)
            if st.conflict is not None:
                st.conflict.encode(w)
    elif isinstance(st, VoteRange):
        w.u8(_ST_VOTE_RANGE)
        st.range.encode(w)
    else:  # pragma: no cover
        raise SerdeError(f"unknown statement type {type(st)}")


def decode_statement(r: Reader) -> BaseStatement:
    tag = r.u8()
    if tag == _ST_SHARE:
        return Share(r.bytes())
    if tag == _ST_VOTE:
        locator = TransactionLocator.decode(r)
        vote_byte = r.u8()
        if vote_byte not in (VOTE_ACCEPT, VOTE_REJECT):
            raise SerdeError(f"invalid vote byte {vote_byte}")
        accept = vote_byte == VOTE_ACCEPT
        conflict = None
        if not accept:
            presence = r.u8()
            if presence not in (0, 1):
                raise SerdeError(f"invalid conflict-presence byte {presence}")
            if presence == 1:
                conflict = TransactionLocator.decode(r)
        return Vote(locator, accept, conflict)
    if tag == _ST_VOTE_RANGE:
        rng = TransactionLocatorRange.decode(r)
        rng.verify()
        return VoteRange(rng)
    raise SerdeError(f"unknown statement tag {tag}")


# --- AuthoritySet -----------------------------------------------------------------


class AuthoritySet:
    """512-bit authority bitset (types.rs:116-121).

    Backed by a single Python int; insertion order does not matter and membership is O(1).
    Used by the committers' vote/certificate predicates and the threshold clock.
    """

    __slots__ = ("bits",)

    def __init__(self, bits: int = 0) -> None:
        self.bits = bits

    def insert(self, authority: AuthorityIndex) -> bool:
        """Returns False if already present (matches reference insert semantics)."""
        if authority >= MAX_COMMITTEE_SIZE:
            raise ValueError(f"authority {authority} out of range (max {MAX_COMMITTEE_SIZE})")
        mask = 1 << authority
        if self.bits & mask:
            return False
        self.bits |= mask
        return True

    def contains(self, authority: AuthorityIndex) -> bool:
        return bool(self.bits >> authority & 1)

    def present(self) -> Iterator[AuthorityIndex]:
        bits = self.bits
        idx = 0
        while bits:
            if bits & 1:
                yield idx
            bits >>= 1
            idx += 1

    def clear(self) -> None:
        self.bits = 0

    def copy(self) -> "AuthoritySet":
        return AuthoritySet(self.bits)

    def __len__(self) -> int:
        return bin(self.bits).count("1")

    def __eq__(self, other: object) -> bool:
        return isinstance(other, AuthoritySet) and self.bits == other.bits

    def __hash__(self) -> int:
        return hash(self.bits)


# --- StatementBlock ---------------------------------------------------------------


class StatementBlock:
    """An immutable DAG block (types.rs:93-114).

    Construction paths:
      * ``StatementBlock.new_genesis(authority)``           — round-0 anchor per authority
      * ``StatementBlock.build(...)`` + signer               — proposing (signs then digests)
      * ``StatementBlock.from_bytes(data)``                  — wire/storage decode

    The canonical serialization (``to_bytes``) is computed once and cached; digest =
    blake2b-256 over it (including signature), signed message = same encoding without
    the signature field (crypto.rs:77-84).
    """

    __slots__ = (
        "reference",
        "includes",
        "statements",
        "meta_creation_time_ns",
        "epoch_marker",
        "epoch",
        "signature",
        "_bytes",
        "_digest_trusted",
        # Share run-length spans precomputed by the native decoder (None on
        # locally built blocks and on the pure-Python decode path).
        "_share_runs",
        # Concatenated 8-byte submission stamps, also decoder-precomputed
        # (the commit observer's latency input).
        "_stamps",
        # blake2b-256 over signed_bytes, precomputed by the batched native
        # digest path (from_bytes_many) or cached on first computation: the
        # signature verifier re-derives it per block otherwise.
        "_signed_digest",
    )

    def __init__(
        self,
        reference: BlockReference,
        includes: Tuple[BlockReference, ...],
        statements: Tuple[BaseStatement, ...],
        meta_creation_time_ns: int,
        epoch_marker: int,
        epoch: Epoch,
        signature: bytes,
        _bytes: Optional[bytes] = None,
        _digest_trusted: bool = False,
    ) -> None:
        self.reference = reference
        self.includes = includes
        self.statements = statements
        self.meta_creation_time_ns = meta_creation_time_ns
        self.epoch_marker = epoch_marker
        self.epoch = epoch
        self.signature = signature
        self._bytes = _bytes
        self._share_runs = None
        self._stamps = None
        self._signed_digest = None
        # True only on construction paths that DERIVED the reference digest
        # from the exact cached bytes (from_bytes): re-hashing the same
        # bytes in verify_structure would compare a hash with itself — at
        # ~1 GB/s over multi-MB blocks that tautology was a top-3 CPU cost
        # at fleet saturation.  Externally-assembled instances default to
        # False and keep the full check.
        self._digest_trusted = _digest_trusted

    # -- constructors --

    @staticmethod
    def _encode_content(
        w: Writer,
        authority: AuthorityIndex,
        round_: RoundNumber,
        includes: Sequence[BlockReference],
        statements: Sequence[BaseStatement],
        meta_creation_time_ns: int,
        epoch_marker: int,
        epoch: Epoch,
    ) -> None:
        w.u64(authority).u64(round_)
        w.u32(len(includes))
        for inc in includes:
            inc.encode(w)
        w.u32(len(statements))
        encode_statements(w, statements)
        w.u64(meta_creation_time_ns)
        w.u8(epoch_marker)
        w.u64(epoch)

    @classmethod
    def build(
        cls,
        authority: AuthorityIndex,
        round_: RoundNumber,
        includes: Iterable[BlockReference],
        statements: Iterable[BaseStatement],
        meta_creation_time_ns: int = 0,
        epoch_marker: int = EPOCH_OPEN,
        epoch: Epoch = 0,
        signer: Optional[crypto.Signer] = None,
    ) -> "StatementBlock":
        """Build and (optionally) sign a new block (crypto.rs:199-223 sign_block)."""
        includes = tuple(includes)
        statements = tuple(statements)
        w = Writer()
        cls._encode_content(
            w, authority, round_, includes, statements, meta_creation_time_ns,
            epoch_marker, epoch,
        )
        unsigned = w.finish()
        signed_digest = crypto.blake2b_256(unsigned)
        if signer is not None:
            signature = signer.sign(signed_digest)
        else:
            signature = crypto.SIGNATURE_NONE
        full = unsigned + signature
        digest = crypto.blake2b_256(full)
        ref = BlockReference(authority, round_, digest)
        block = cls(
            ref, includes, statements, meta_creation_time_ns, epoch_marker, epoch,
            signature, _bytes=full,
        )
        # The signing pre-hash IS signed_digest; keep it so self-verification
        # (and the batch verifier's message input) skips a redundant hash pass.
        block._signed_digest = signed_digest
        return block

    @classmethod
    def new_genesis(cls, authority: AuthorityIndex, epoch: Epoch = 0) -> "StatementBlock":
        """Round-0 anchor block; never signed, never verified (committee.rs:98)."""
        return cls.build(authority, GENESIS_ROUND, (), (), epoch=epoch)

    # -- serialization --

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            w = Writer()
            self._encode_content(
                w, self.reference.authority, self.reference.round, self.includes,
                self.statements, self.meta_creation_time_ns, self.epoch_marker, self.epoch,
            )
            w.fixed(self.signature)
            self._bytes = w.finish()
        return self._bytes

    def signed_bytes(self) -> bytes:
        """The encoding covered by the signature: everything but the signature itself."""
        return self.to_bytes()[: -crypto.SIGNATURE_SIZE]

    def signed_digest(self) -> bytes:
        """blake2b-256 of signed_bytes — the 32-byte message Ed25519 actually signs.

        This fixed-width message is what makes the batch verifier's SHA-512 input
        a constant shape (R || A || 32-byte digest = one 128-byte SHA-512 block).
        Cached: the batched native decode path (``from_bytes_many``) precomputes it
        alongside the block digest, one GIL round-trip per frame instead of one
        hash pass per verified block.
        """
        if self._signed_digest is None:
            self._signed_digest = crypto.blake2b_256(self.signed_bytes())
        return self._signed_digest

    # Decode memo, enabled ONLY by the deterministic simulator
    # (runtime/simulated.py): all N simulated validators live in one process
    # and each decodes the same serialized block once — memoizing turns the
    # sim's dominant cost (N redundant decodes per block) into one.  Blocks
    # are immutable after construction, so instance sharing across in-process
    # nodes is safe.  Never enabled on real nodes (each is its own process).
    _decode_memo: Optional[dict] = None
    _DECODE_MEMO_CAP = 8192

    @classmethod
    def enable_decode_memo(cls) -> None:
        cls._decode_memo = {}

    @classmethod
    def disable_decode_memo(cls) -> None:
        cls._decode_memo = None

    @classmethod
    def from_bytes(cls, data) -> "StatementBlock":
        """Single-pass inline decoder over ``bytes`` or any buffer view.

        Wire format identical to the Reader-based encoders above; this path
        unpacks with local offsets instead of per-field Reader calls.  Error
        semantics match: any truncation, bad tag, invalid vote byte, or
        trailing garbage raises SerdeError.

        Memoryview inputs (the zero-copy receive path: block payloads are
        sub-views over a connection's reusable frame buffer) are
        materialized EXACTLY ONCE here — the copy that becomes the cached
        canonical serialization the digest and signature cover; nothing
        downstream retains a view of the caller's buffer."""
        if type(data) is not bytes:  # memoryview/mmap callers
            data = bytes(data)
        memo = cls._decode_memo
        if memo is not None:
            cached = memo.get(data)
            if cached is not None:
                return cached
        if _native_decode is not None:
            # Native single-pass decoder (native/mysticeti_native.cpp):
            # identical wire format and rejection cases, differentially
            # tested against the pure-Python path below.
            try:
                decoded = _native_decode(data)
            except ValueError as exc:
                raise SerdeError(str(exc)) from None
            # Unpack OUTSIDE the except: an arity mismatch here means a
            # stale compiled extension (build skew) and must fail loudly,
            # not masquerade as malformed wire data.
            (authority, round_, includes, statements, meta_ns,
             epoch_marker, epoch, signature, share_runs, stamps) = decoded
            digest = crypto.blake2b_256(data)
            block = cls(
                BlockReference(authority, round_, digest), tuple(includes),
                tuple(statements), meta_ns, epoch_marker, epoch, signature,
                _bytes=data, _digest_trusted=True,
            )
            block._share_runs = share_runs
            block._stamps = stamps
            if memo is not None:
                if len(memo) >= cls._DECODE_MEMO_CAP:
                    memo.clear()
                memo[block._bytes] = block
            return block
        try:
            n = len(data)
            authority, round_ = _U64X2.unpack_from(data, 0)
            pos = 16
            (cnt,) = _U32_AT.unpack_from(data, pos)
            pos += 4
            includes = []
            for _ in range(cnt):
                a, rr = _U64X2.unpack_from(data, pos)
                digest = bytes(data[pos + 16 : pos + 48])
                if len(digest) != crypto.DIGEST_SIZE:
                    raise SerdeError("truncated input: include digest")
                includes.append(BlockReference(a, rr, digest))
                pos += 48
            (cnt,) = _U32_AT.unpack_from(data, pos)
            pos += 4
            statements = []
            for _ in range(cnt):
                tag = data[pos]
                pos += 1
                if tag == _ST_SHARE:
                    (ln,) = _U32_AT.unpack_from(data, pos)
                    pos += 4
                    end = pos + ln
                    if end > n:
                        raise SerdeError("truncated input: share payload")
                    statements.append(Share(bytes(data[pos:end])))
                    pos = end
                elif tag == _ST_VOTE:
                    a, rr = _U64X2.unpack_from(data, pos)
                    digest = bytes(data[pos + 16 : pos + 48])
                    if len(digest) != crypto.DIGEST_SIZE:
                        raise SerdeError("truncated input: vote digest")
                    (off,) = _U64_AT.unpack_from(data, pos + 48)
                    locator = TransactionLocator(BlockReference(a, rr, digest), off)
                    pos += 56
                    vote_byte = data[pos]
                    pos += 1
                    if vote_byte not in (VOTE_ACCEPT, VOTE_REJECT):
                        raise SerdeError(f"invalid vote byte {vote_byte}")
                    accept = vote_byte == VOTE_ACCEPT
                    conflict = None
                    if not accept:
                        presence = data[pos]
                        pos += 1
                        if presence not in (0, 1):
                            raise SerdeError(
                                f"invalid conflict-presence byte {presence}"
                            )
                        if presence == 1:
                            a2, rr2 = _U64X2.unpack_from(data, pos)
                            digest2 = bytes(data[pos + 16 : pos + 48])
                            if len(digest2) != crypto.DIGEST_SIZE:
                                raise SerdeError("truncated input: conflict")
                            (off2,) = _U64_AT.unpack_from(data, pos + 48)
                            conflict = TransactionLocator(
                                BlockReference(a2, rr2, digest2), off2
                            )
                            pos += 56
                    statements.append(Vote(locator, accept, conflict))
                elif tag == _ST_VOTE_RANGE:
                    a, rr = _U64X2.unpack_from(data, pos)
                    digest = bytes(data[pos + 16 : pos + 48])
                    if len(digest) != crypto.DIGEST_SIZE:
                        raise SerdeError("truncated input: range digest")
                    s, e = _U64X2.unpack_from(data, pos + 48)
                    rng = TransactionLocatorRange(BlockReference(a, rr, digest), s, e)
                    rng.verify()
                    statements.append(VoteRange(rng))
                    pos += 64
                else:
                    raise SerdeError(f"unknown statement tag {tag}")
            (meta_ns,) = _U64_AT.unpack_from(data, pos)
            pos += 8
            epoch_marker = data[pos]
            pos += 1
            (epoch,) = _U64_AT.unpack_from(data, pos)
            pos += 8
            signature = bytes(data[pos : pos + crypto.SIGNATURE_SIZE])
            if len(signature) != crypto.SIGNATURE_SIZE:
                raise SerdeError("truncated input: signature")
            pos += crypto.SIGNATURE_SIZE
            if pos != n:
                raise SerdeError(f"trailing garbage: {n - pos} bytes")
        except struct.error:
            raise SerdeError("truncated input") from None
        except IndexError:
            raise SerdeError("truncated input") from None
        digest = crypto.blake2b_256(data)
        ref = BlockReference(authority, round_, digest)
        block = cls(
            ref, tuple(includes), tuple(statements), meta_ns, epoch_marker,
            epoch, signature, _bytes=bytes(data), _digest_trusted=True,
        )
        if memo is not None:
            if len(memo) >= cls._DECODE_MEMO_CAP:
                memo.clear()  # bulk FIFO: sims re-see bytes within a window
            memo[block._bytes] = block
        return block

    @classmethod
    def from_bytes_many(cls, raws) -> List[Optional["StatementBlock"]]:
        """Batched decode of N serialized blocks; ``None`` marks a malformed entry.

        The receive-path sibling of ``from_bytes`` for whole-frame ingest:
        all N block digests AND signature pre-hashes are computed in ONE
        native call with the GIL released (``block_digests``), so a K-block
        frame costs one GIL round-trip instead of K hashlib calls.  Falls
        back to per-raw ``from_bytes`` when the extension is absent or the
        sim decode memo is active — the memo path must stay byte-identical
        (and instance-identical) under seeded simulation.
        """
        if _native_decode is None or _native_block_digests is None \
                or cls._decode_memo is not None:
            out = []
            for data in raws:
                try:
                    out.append(cls.from_bytes(data))
                except SerdeError:
                    out.append(None)
            return out
        datas = [data if type(data) is bytes else bytes(data) for data in raws]
        decoded = []
        good = []
        for data in datas:
            try:
                decoded.append(_native_decode(data))
                good.append(data)
            except ValueError:
                decoded.append(None)
        digests = iter(_native_block_digests(good))
        out: List[Optional["StatementBlock"]] = []
        for data, dec in zip(datas, decoded):
            if dec is None:
                out.append(None)
                continue
            # Unpack OUTSIDE any except (same contract as from_bytes): an
            # arity mismatch means extension build skew, not bad wire data.
            (authority, round_, includes, statements, meta_ns,
             epoch_marker, epoch, signature, share_runs, stamps) = dec
            digest, signed_digest = next(digests)
            block = cls(
                BlockReference(authority, round_, digest), tuple(includes),
                tuple(statements), meta_ns, epoch_marker, epoch, signature,
                _bytes=data, _digest_trusted=True,
            )
            block._share_runs = share_runs
            block._stamps = stamps
            block._signed_digest = signed_digest
            out.append(block)
        return out

    # -- accessors --

    def author(self) -> AuthorityIndex:
        return self.reference.authority

    def round(self) -> RoundNumber:
        return self.reference.round

    def digest(self) -> bytes:
        return self.reference.digest

    def author_round(self) -> Tuple[AuthorityIndex, RoundNumber]:
        return self.reference.author_round()

    def epoch_changed(self) -> bool:
        return self.epoch_marker != EPOCH_OPEN

    def shared_transactions(self) -> Iterator[Tuple["TransactionLocator", bytes]]:
        """(locator, payload) for every Share statement (types.rs shared_transactions)."""
        for offset, st in enumerate(self.statements):
            if isinstance(st, Share):
                yield TransactionLocator(self.reference, offset), st.transaction

    def shared_transaction_stamps(self) -> bytes:
        """Concatenated first-8-byte prefixes of every Share payload — the
        benchmark submission stamps the commit observer's latency metrics
        read.  A dedicated path because ``shared_transactions`` constructs a
        locator per transaction: at saturation that was ~1M frozen-dataclass
        builds per reporting window, discarded immediately (round-5 profile).
        """
        if self._stamps is not None:  # decoder-precomputed (wire blocks)
            return self._stamps
        out = []
        for st in self.statements:
            if isinstance(st, Share):
                t = st.transaction
                # Sub-8-byte payloads carry no stamp: emit ZERO so the
                # ts==0 "unstamped" guard downstream zeroes their latency
                # (padding real bytes would decode as a denormal float).
                out.append(t[:8] if len(t) >= 8 else b"\x00" * 8)
        return b"".join(out)

    # -- verification (types.rs:315-376) --

    def verify_structure(self, committee) -> None:
        """Consensus-rule checks minus the signature: digest match, epoch match, known
        author, include-round monotonicity, vote-range bounds, threshold-clock validity.

        The signature check itself is intentionally *separate* (``signed_digest`` +
        authority key) so the network layer can strip it out of the serial path and
        batch it on the accelerator; ``verify`` below is the all-in-one CPU equivalent.
        """
        from .threshold_clock import threshold_clock_valid_non_genesis

        if not self._digest_trusted:
            data = self.to_bytes()
            if crypto.blake2b_256(data) != self.reference.digest:
                raise VerificationError(
                    f"digest mismatch for {self.reference!r}"
                )
        if not committee.accepts_epoch(self.epoch):
            raise VerificationError(
                f"block epoch {self.epoch} != committee epoch {committee.epoch}"
            )
        if not committee.known_authority(self.author()):
            raise VerificationError(f"unknown block author {self.author()}")
        if self.round() == GENESIS_ROUND:
            raise VerificationError("genesis block should not go through verification")
        for include in self.includes:
            if not committee.known_authority(include.authority):
                raise VerificationError(f"include {include!r} references unknown authority")
            if include.round >= self.round():
                raise VerificationError(
                    f"include {include!r} round >= own round {self.round()}"
                )
        for st in self.statements:
            if isinstance(st, VoteRange):
                st.range.verify()
        if not threshold_clock_valid_non_genesis(self, committee):
            raise VerificationError(f"threshold clock not valid for {self.reference!r}")

    def verify(self, committee) -> None:
        """Full verification including the Ed25519 signature (types.rs:315-376 +
        crypto.rs:174-189).  The accelerator path runs verify_structure on host and the
        signature equation on device."""
        self.verify_structure(committee)
        pub_key = committee.get_public_key(self.author())
        if not pub_key.verify(self.signature, self.signed_digest()):
            raise VerificationError(f"signature verification failed for {self.reference!r}")

    def __repr__(self) -> str:
        return f"{self.reference!r}([{','.join(repr(i) for i in self.includes)}])"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, StatementBlock) and self.reference == other.reference

    def __hash__(self) -> int:
        return hash(self.reference)


class VerificationError(ValueError):
    """A block failed consensus-rule or signature verification."""


# Native decoder wiring: register the statement/reference classes with the
# C++ extension once, then resolve the fast path from_bytes dispatches to.
from .native import native as _native_mod  # noqa: E402

_native_decode = None
_native_block_digests = None
if _native_mod is not None and hasattr(_native_mod, "decode_block"):
    _native_mod.decode_register(
        BlockReference, Share, Vote, VoteRange, TransactionLocator,
        TransactionLocatorRange,
    )
    _native_decode = _native_mod.decode_block
if _native_mod is not None and hasattr(_native_mod, "block_digests"):
    # Batched (digest, signed-prehash) pairs, held to crypto.blake2b_256 by
    # the port's native tests.
    _native_block_digests = _native_mod.block_digests
