"""Canonical deterministic binary serialization for consensus objects.

The reference uses bincode for every wire/storage encoding (e.g. Data<T> caching in
``mysticeti-core/src/data.rs:22-44`` and the 4-byte length-prefixed frames in
``mysticeti-core/src/network.rs:397-459``).  This framework defines its own compact
little-endian format instead — bincode compatibility is not a goal; determinism and
zero-ambiguity are, because block digests and signatures are computed over these bytes.

Format primitives:
  u8 / u32 / u64  little-endian fixed width
  bytes           u32 length prefix + raw bytes
  list            u32 count prefix + items
All composite encoders write into a single ``bytearray`` to avoid intermediate copies.
"""
from __future__ import annotations

import struct

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class Writer:
    """Append-only canonical encoder."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> "Writer":
        self.buf += _U8.pack(v)
        return self

    def u32(self, v: int) -> "Writer":
        self.buf += _U32.pack(v)
        return self

    def u64(self, v: int) -> "Writer":
        self.buf += _U64.pack(v)
        return self

    def fixed(self, b: bytes) -> "Writer":
        """Raw bytes with no length prefix (fixed-size fields like digests/signatures)."""
        self.buf += b
        return self

    def bytes(self, b: bytes) -> "Writer":
        self.buf += _U32.pack(len(b))
        self.buf += b
        return self

    def finish(self) -> bytes:
        return bytes(self.buf)


class Reader:
    """Sequential canonical decoder with bounds checking.

    ``data`` may be ``bytes`` or a ``memoryview``.  With a memoryview input
    the variable-length :meth:`bytes` fields come back as sub-views over the
    caller's buffer — the zero-copy receive mode the mesh read path uses for
    block payloads (``network.decode_message``); the caller owns the buffer
    lifetime and must materialize (``bytes(view)``) anything that outlives
    it.  Fixed-width fields (:meth:`fixed`) always materialize: digests and
    signatures are used as dict keys and must stay hashable.
    """

    __slots__ = ("data", "pos")

    def __init__(self, data, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def _take(self, n: int):
        end = self.pos + n
        if end > len(self.data):
            # Error text contract: the native batched parser
            # (mysticeti_native.cpp parse_blocks_spans) reproduces this
            # exact message — the data-plane parity corpus asserts torn
            # frames are indistinguishable across the native/fallback
            # paths, so any wording change here must land there too.
            raise SerdeError(
                f"truncated input: need {n} bytes at {self.pos}, have {len(self.data)}"
            )
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def u8(self) -> int:
        return _U8.unpack(self._take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self._take(8))[0]

    def fixed(self, n: int) -> bytes:
        return bytes(self._take(n))

    def bytes(self):
        """Length-prefixed field: a fresh ``bytes`` for bytes input, a
        zero-copy sub-view for memoryview input (see class docstring)."""
        n = self.u32()
        return self._take(n)

    def done(self) -> bool:
        return self.pos == len(self.data)

    def expect_done(self) -> None:
        if not self.done():
            # Same contract as _take: the native parser emits this message
            # verbatim for over-long Blocks payloads.
            raise SerdeError(f"trailing garbage: {len(self.data) - self.pos} bytes")


class SerdeError(ValueError):
    pass
