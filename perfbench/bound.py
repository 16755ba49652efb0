"""The least time the card needs for the window's signatures: a frozen copy of
the bound model that the port's kernel phase stated (``chip_smoke.py`` with
``ed25519_cuda.keyed_lane_ops``), kept here so that no change to the program
can move the yardstick.

Peaks of one NVIDIA H100 SXM at its published 1.98 GHz boost clock: 32-bit
integer multiply-add and add/logic run at 64 per SM per clock on compute
capability 9.0 (half the float32 FMA rate behind the published 67 TFLOP/s),
over 132 SMs; device memory moves 3.35 TB/s.  Both assume the card's full
700 W power limit.
"""
from __future__ import annotations

INT_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12

# A 255-bit field multiply needs at least 8 x 8 32-bit limb products; a
# squaring 8 squares and 28 cross products.
INT_MULS_PER_FIELD_MUL = 64
INT_MULS_PER_FIELD_SQ = 36
# One SHA-512 compression in 32-bit integer instructions with funnel shifts
# and three-input logic: 80 rounds x 36 + 64 schedule steps x 22.
SHA512_INT_OPS = 80 * 36 + 64 * 22
# The 512-bit digest mod L: folds by 2^252 = -c (mod L), c < 2^125.
MOD_L_INT_OPS = 9 * 4 + 5 * 4 + 1 * 4
PROLOGUE_INT_OPS = SHA512_INT_OPS + MOD_L_INT_OPS
# A keyed lane: 128 Niels additions of 7 multiplies (64 from the base comb,
# 64 from its key's comb) and the compare against R (an inversion of 254
# squarings and 13 multiplies).
KEYED_LANE_SQUARINGS = 254
KEYED_LANE_MULTIPLIES = 128 * 7 + 13
KEYED_INT_OPS = (KEYED_LANE_SQUARINGS * INT_MULS_PER_FIELD_SQ
                 + KEYED_LANE_MULTIPLIES * INT_MULS_PER_FIELD_MUL)
# What one live lane reads from and writes to device memory: the indexed
# record (26 32-bit words: key index, R, S, message) and a one-byte verdict.
# The key combs (64 x 16 entries of 16 64-bit words a key) and the base comb
# stay in the 50 MB L2 across flushes for committees of up to ~300 keys, so
# they are not charged to every flush.
LANE_BYTES = 26 * 4 + 1


def signature_ops() -> int:
    """32-bit integer operations one verified signature needs at least."""
    return PROLOGUE_INT_OPS + KEYED_INT_OPS


def least_seconds(live_lanes: int) -> tuple:
    """(seconds, "operations" or "bytes"): the least time ``live_lanes``
    verified signatures take, whichever of the two peaks bounds it."""
    t_ops = live_lanes * signature_ops() / INT_OPS_PER_S
    t_bytes = live_lanes * LANE_BYTES / BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
