"""Peaks of one H100 and the least time each hand-written kernel could take.

The counts are those of ``chip_smoke.py`` (``bound``, ``ntt_bound``,
``ntt_small_bound``, ``ks_bound``), copied here so the
yardstick sits with the benchmark: a later change to the program cannot move
it. Every count is what the algorithm needs at the call's shapes: each input
byte read once and each output byte written once, and the integer operations
of the arithmetic, whichever takes longer at the peaks below.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
# 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12
# The data sheet gives no integer rate outside the tensor cores. Its 67
# TFLOP/s of float32 is 128 lanes x 2 (a fused multiply-add) on each of 132
# SMs at 1.98 GHz; 32-bit integer multiply-adds issue on 64 lanes of an SM,
# a quarter of the float32 flops: 67e12 / 4 = 16.75e12 operations a second.
INT32_OPS_PER_S = 67e12 / 4


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least: the bytes at the HBM rate or the
    32-bit integer operations at the integer rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def ntt_bound(rows: int, towers: int, n: int) -> float:
    """Four-step NTT of [rows, n] over `towers` moduli: the data read and
    written (16 bytes a coefficient) and the twist with its precon (16 bytes
    a tower coefficient); n/2 log2 n butterflies a row at 16 integer
    operations (a Shoup product is ten 32-bit multiply-adds, then three
    two-word additions) and n twists at 12."""
    butterflies = rows * (n // 2) * (n.bit_length() - 1)
    return bound_s(16 * rows * n + 16 * towers * n,
                   16 * butterflies + 12 * rows * n)


def ntt_small_bound(rows: int, towers: int, n: int) -> float:
    """The merged small-ring NTT of [rows, n] over `towers` moduli: the data
    read and written and the tower's twiddle pairs (16 bytes a coefficient
    each); n/2 log2 n butterflies a row at 16 integer operations, no
    twist."""
    butterflies = rows * (n // 2) * (n.bit_length() - 1)
    return bound_s(16 * rows * n + 16 * towers * n, 16 * butterflies)


SMALL_MAX_N = 1 << 11  # rings up to this take the merged network


def ntt_any_bound(rows: int, towers: int, n: int) -> float:
    """The bound of the decomposition the ring takes: the merged network
    up to 2^11, the four-step above."""
    fn = ntt_small_bound if n <= SMALL_MAX_N else ntt_bound
    return fn(rows, towers, n)


def ks_bound(ndig: int, rows: int, n: int, key_rows: int | None = None,
             rows_on_device: bool = False, mono_rows: int = 0) -> float:
    """ks_inner_product over [ndig, rows, n]: the digits, both key halves
    (`key_rows` distinct rows of them, default one per output row) and both
    outputs once; per output a 64x64->128 product a digit (four multiply-adds
    and four additions to accumulate) and a final reduction of some twenty
    operations. A rows index on the device adds its 8 bytes a row; an
    epilogue over `mono_rows` distinct rows of the table adds those rows and
    its index, and per output a full product (eight operations) and a
    reduction."""
    key_rows = rows if key_rows is None else key_rows
    index = 8 * rows * (bool(rows_on_device) + bool(mono_rows))
    return bound_s(8 * n * (ndig * rows + 2 * ndig * key_rows + 2 * rows
                            + mono_rows) + index,
                   rows * n * 2 * (8 * ndig + 20 + (28 if mono_rows else 0)))

