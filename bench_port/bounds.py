"""Frozen bound arithmetic for the kernels' roofline shares to come.

A copy of ``chip_smoke.py``'s peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at the full 700 W power limit) and its operation
counts of K1, K2, K3 and K5, kept under the benchmark so that a later
change to the program cannot change the yardstick.  No metric reads it
yet: a kernel's roofline share needs each launch's work (rows scanned,
sweeps, valid pairs), which the program does not record per launch.

Where ``chip_smoke.py`` asks the program (K3's table of the mult FD
factor and whether it fits shared memory), the number is a constant here
(``LUT_N``) or an argument (``table_fits``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # device memory
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12    # bf16 tensor cores, dense
INT8_TC_OPS_PER_S = 1979e12    # int8 tensor cores, dense

# SASS instructions of __fsqrt_rn, expf, logf and csrc/stream.cu's
# sqrt_rn as nvcc builds them for sm_90a with the kernels' flags
# (-fmad=false): each routine's straight path to its first EXIT in a
# one-call kernel, less an identity kernel's (chip_smoke.py::sass_counts
# on an NVIDIA H100 80GB HBM3)
SASS_COUNTS = {"sqrt": 13, "exp": 10, "log": 27, "sqrt_rn": 13}

# K3's table of the mult FD factor: every bf16 value in [0, 1]
LUT_N = 0x3F81

# K3's other operations on each rebuilt entry (csrc/auction.cu
# entry_benefit and its sweep): the ED dot product and clamp (9), the
# blend (3) or the mult form's floor and products (3), the negation and
# mask (3), the price (1), the top-2 push (5), vsel (3), the benefit max
# (1) and the bf16 unpack (1)
K3_ENTRY_OPS = 26
# the bf16 mult form with its table: the lookup's sign test, select, range
# compare and shared load (4) less the floor and the -k product (2)
K3_LUT_OPS = 2
# a table entry: expf, logf (SASS counts), the unpack, the floor and the
# -k product
K3_TABLE_EXTRA_OPS = 3
# K1's operations on each entry (csrc/cost.cu cost_kernel): the ED dot
# product, clamp and scale (10), the negation and the mask test (3), the
# price (1), v1 (1), vsel's column test and maximum (3), the ED and
# benefit maxima (2); with the statistics the count, the two sums, the
# square and the CD maximum (5); the BSC blend (3) or the mult form's
# product (1) and its FD factor: the table's lookup (4) or the floor and
# -k product (2) with expf and logf; bf16's unpack, rounding and packing
K1_ENTRY_OPS = 20
K1_STATS_OPS = 5
K1_BSC_OPS = 3
K1_MULT_OPS = 1
K1_LUT_OPS = 4
K1_FLOOR_OPS = 2
K1_BF16_OPS = 3
# K2's operations on each entry a part scan reads: the price subtraction
# and the top-2 push (csrc/auction.cu MatScan)
K2_ENTRY_OPS = 5
# K5-mult's float32-lane operations a valid pair besides the dot product,
# the square root, expf and logf; the statistics' and the column side's
K5_MULT_PAIR_OPS = 14
K5_STATS_OPS = 6
K5_COL_OPS = 2


def bound_ms(n_bytes: float, n_ops: float, ops_per_s=FP32_FLOP_PER_S):
    """(the least milliseconds, "bytes" or "operations"): the larger of
    the bytes over the memory rate and the operations over the rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k3_ops(mult: bool, f32: bool, table_fits: bool, blocks: int,
           c=SASS_COUNTS) -> tuple:
    """K3's operations: (an entry rebuilt, the launch's fixed work).  The
    mult form adds expf's and logf's, or, in bf16 where its table fits
    shared memory, K3_LUT_OPS and each of the ``blocks`` fills the
    table's LUT_N entries once."""
    ops = K3_ENTRY_OPS + c["sqrt"]
    if not mult:
        return ops, 0
    if not f32 and table_fits:
        return ops + K3_LUT_OPS, blocks * LUT_N * (
            c["exp"] + c["log"] + K3_TABLE_EXTRA_OPS)
    return ops + c["exp"] + c["log"], 0


def k1_ops(mult: bool, f32: bool, stats: bool, blocks: int,
           c=SASS_COUNTS) -> tuple:
    """K1's operations: (an entry, the launch's fixed work), as the
    kernel instantiated for this form does them."""
    ops = K1_ENTRY_OPS + c["sqrt"] + (K1_STATS_OPS if stats else 0)
    if not f32:
        ops += K1_BF16_OPS
    if not mult:
        return ops + K1_BSC_OPS, 0
    if not f32:
        return ops + K1_MULT_OPS + K1_LUT_OPS, blocks * LUT_N * (
            c["exp"] + c["log"] + K3_TABLE_EXTRA_OPS)
    return ops + K1_MULT_OPS + K1_FLOOR_OPS + c["exp"] + c["log"], 0


def k1_blocks(S: int, sms: int = 132) -> int:
    """K1's blocks a launch: a band of 64 rows each, at most one an SM."""
    return min(-(-S // 64), sms)


def k5_bound(rows: int, C: int, pairs: float, V: int,
             col: bool = False, width: int = 0) -> tuple:
    """((least ms, what bounds it), this design's ms) of a Hamming-lane K5
    sweep over ``pairs`` valid pairs at V variants: the Hamming term as
    int8 tensor-core products (2 x 441 a variant and valid pair) or 13
    float32 operations a pair (the column side 2 more), the slower, over
    the bytes read and written once; the design's products (2 x 448 a
    variant and pair of the tiles, ``width`` variants where the kernel
    pads V) at the int8 rate plus 16 float32 operations a valid pair."""
    W, n_bits = 14, 441
    nbytes = ((rows + C) * (16 + 4) + (V * rows + C) * W * 4 + C * 4
              + rows * 4 + rows * 20 + (C * 8 if col else 0))
    best = max(bound_ms(nbytes, 2.0 * n_bits * V * pairs,
                        INT8_TC_OPS_PER_S),
               bound_ms(nbytes, (13.0 + (2.0 if col else 0.0)) * pairs))
    design = (2.0 * 32 * W * max(V, width) * rows * C / INT8_TC_OPS_PER_S
              + 16.0 * pairs / FP32_FLOP_PER_S) * 1e3
    return best, design


def k5_mult_ops(stats: bool, col: bool = False, c=SASS_COUNTS) -> int:
    """K5-mult's float32-lane operations a valid pair (the dot aside)."""
    return (K5_MULT_PAIR_OPS + c["sqrt_rn"] + c["exp"] + c["log"]
            + (K5_STATS_OPS if stats else 0) + (K5_COL_OPS if col else 0))


def k5_mult_bound(rows: int, C: int, pairs: float, D: int, stats: bool,
                  col: bool = False) -> tuple:
    """(least ms, what bounds it, the float32 design's ms) of a K5-mult
    sweep: the dot products (2 D a valid pair) at the bf16 tensor-core
    rate or the rest on the float32 lanes, the slower, over the bytes the
    kernel reads (ceil(D / 8) 16-byte chunks a row) and writes once."""
    nbytes = ((rows + C) * (16 + 16 * -(-D // 8)) + rows * (1 + 8 + 28)
              + C * (1 + 4) + (C * 12 if col else 0))
    ops = k5_mult_ops(stats, col)
    best = max(bound_ms(nbytes, 2.0 * D * pairs, BF16_TC_FLOP_PER_S),
               bound_ms(nbytes, ops * pairs))
    return best[0], best[1], bound_ms(nbytes, (2.0 * D + ops) * pairs)[0]
