"""Matrix-free streaming cost sweep (kernel K5), CUDA C++ in
``csrc/stream.cu``, with its plain PyTorch version.

Replaces ``ghicp_tpu/ops/stream_kernel.py::stream_sweep`` (Pallas
``_kernel``) on its Hamming (BSC) lane and its similarity (FPFH/RoPS,
multiplicative blend) lane; the features' type picks the lane.  One sweep computes, for every source row against
every target column, without materializing [S, C]:

  ED = scale * sqrt(max(|s|^2 + |t|^2 - 2 s.t, 0))   (fixed product order)
  BSC:  FD = min over the V source variants of popc(a_v XOR b)
        CD = W_ED * ED + W_FD * FD
  FPFH/RoPS: sim = max(|fs_i . ft_j|, 1e-6) over standardized bf16 rows
        (:class:`DescFeatures`), CD = ED * exp(-k log(sim)), k = W_FD
  none: CD = W_ED * ED, FD = 0
  v = -CD - p[j] at valid pairs

and keeps per row the top-2 of v (v1, j1, v2, j2; the lowest column on
exact ties), v at the previous assignment ``acol`` (vsel), and the
statistics count, sum CD, sum CD^2, max CD, max ED, max -CD and max FD
over valid pairs (``with_stats=False``: not computed, NaN).  The BSC
features come in two forms: packed, 32 bits a word, ``W`` words a row (14
for the 441 bits), and unpacked, one {0, 1} int8 a bit, 448 a row.  For
{0, 1} bits, |a| + |b| - 2 a.b = popc(a XOR b) exactly, so the plain
version's float32 product of the unpacked bits, the tensor-core kernel's
int8 product and the gathers' XOR + POPC give the same integers.  On the
similarity lane a product of two bf16 values is exact in float32, so only
the order of the sum over the D dimensions matters: both
versions add them in increasing order, and the plain one never calls a
matrix product, whose order is its own.

Bound on this card: the Hamming lane's int8 products on the tensor cores
(2 x 448 operations a variant and pair) or its float epilogue, whichever
is slower; float operations on the similarity lane, 2 D a pair plus the
blend; on the feature-"none" lane (:class:`NoFeatures`, no factor is
read, CD = W_ED * ED) the float operations of ED, the blend and the
top-2.  The bytes (coordinates and factors, read once) are a few MB.
``col_side`` (every lane; the reciprocal-NN matcher) adds per column the
least CD over valid rows and the lowest row that reaches it (``cmin`` /
``crow``).  The design notes are at the head of the CUDA source: one
register-tiled kernel a lane (the Hamming lane's on the int8 tensor
cores), each with its column side.  What every sweep of a solve reads of
the target is made once (:class:`SweepTarget`).  Every
variant counts its launches under its own name (``stream_sweep``,
``stream_sweep_mult``, ``stream_sweep_none``, each with a ``_col`` twin),
and once more under ``<name>@<rows>``, its rows, so that full-height and
compacted sweeps can be priced apart.

:func:`stream_selected` (matched-pair gathers),
:func:`stream_feature_candidates` (the RANSAC candidates; a ``lax.scan``
in the JAX package, not a kernel) and :func:`make_desc_features` are plain
PyTorch on either device.

The ring lane (:func:`ring_sweep`, the JAX package's ``ring_sweep``; no
kernel of its own): the target's factor rows are sharded over the ranks
of a :class:`~ghicp_tpu_torch.core.comm.Comm` (:class:`RingFeatures`),
and one sweep is n steps of K5, each on this rank's rows against the
target block it holds, the block then passed to the neighbour (the int8
bit rows K5 reads, so nothing is unpacked again); the per-row top-2 is
merged under (value desc, column asc) and the statistics summed.
"""
from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional

import torch

from ghicp_tpu_torch.ops import as_rows, count_launch, require_device
from ghicp_tpu_torch.ops.cost_kernel import (_f32, _factors, factor_cost,
                                             factor_ed, mult_cost)

NEG = -3.0e38
NO_COL = 3.0e38     # cmin of a column without a valid row
NO_ROW = 2**30      # its crow
# the kernel's column key of such a column: (bits(float32 NO_COL) << 32) |
# NO_ROW
_COL_KEY0 = (struct.unpack("<I", struct.pack("<f", NO_COL))[0] << 32) | NO_ROW
RT = 64         # rows a block of the Hamming kernel (the compaction granule)
HAM_TC = 64     # columns a tile of the Hamming kernel
NONE_RT = 128   # rows a block of the none kernel
NONE_TC = 128   # columns a tile of the none kernel
DESC_RT = 64    # rows a block of the similarity kernel
DESC_TM = 4     # its rows a thread
DESC_TN = 4     # its columns a thread takes at once
DESC_PASS = 32  # its columns a pass
PLAIN_TC = 1024
KERNEL_MAX_VARIANTS = 28   # ham_kernel at V = 1, 2, 4; hamg_kernel to 28
BIT_ROW = 448   # unpacked bits a row: 14 words of 32
_M32 = 0xFFFFFFFF


class StreamFeatures(NamedTuple):
    """Factor representation of the BSC feature distance: the bits packed
    (the plain version, gathers, the kernel's target tiles) and unpacked
    (the kernel's source rows and vsel), made once a registration."""

    words_s: torch.Tensor   # [V, S, W] int32 source bits (variants)
    words_t: torch.Tensor   # [C, W] int32 target bits (variant 0)
    na: torch.Tensor        # [V, S] float32 popcounts
    nb: torch.Tensor        # [C] float32 popcounts
    bits_s: torch.Tensor    # [V, S, 32 W] int8 {0, 1}, bit k of word w at
                            # 32 w + k
    bits_t: torch.Tensor    # [C, 32 W] int8


class DescFeatures(NamedTuple):
    """Factor rows of the FPFH/RoPS similarity: the standardized
    descriptors, |fs_i . ft_j| = the similarity matrix."""

    fs: torch.Tensor        # [S, F] bfloat16 source rows (zero past dim)
    ft: torch.Tensor        # [C, F] bfloat16 target rows
    dim: int                # D, the descriptor length (F = D rounded up
                            # to a multiple of 128)


class NoFeatures(NamedTuple):
    """The feature-"none" lane's factors: there are none.  CD = W_ED * ED
    and FD = 0; no bit or descriptor row is allocated or read."""

    n_rows: int             # S, the source rows (checked by the sweep)


class SweepResult(NamedTuple):
    v1: torch.Tensor        # [S] max_j (b - p)
    j1: torch.Tensor        # [S] int64 its column (lowest on ties)
    v2: torch.Tensor        # [S] best over the other columns
    j2: torch.Tensor        # [S] int64 its column
    vsel: torch.Tensor      # [S] (b - p) at acol (NEG if not a column)
    cnt: torch.Tensor       # valid pairs (float32 of the exact count)
    cd_sum: torch.Tensor
    cd_sumsq: torch.Tensor
    cd_max: torch.Tensor
    ed_max: torch.Tensor
    b_max: torch.Tensor     # max -CD over valid pairs
    fd_max: torch.Tensor    # max FD over valid pairs
    # ``col_side`` only: [C] least CD over valid rows, and the lowest row
    # reaching it (3e38 and 2^30 where a column has no valid row)
    cmin: Optional[torch.Tensor] = None
    crow: Optional[torch.Tensor] = None


STAT_FIELDS = ("cnt", "cd_sum", "cd_sumsq", "cd_max", "ed_max", "b_max",
               "fd_max")
STAT_SUMS = STAT_FIELDS[:3]


def to_words(packed: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32 bits each -> int32 words (same bits)."""
    p = packed.to(torch.int64) & _M32
    return torch.where(p >= 2**31, p - 2**32, p).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., 32 W] float32 {0, 1} bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = ((words.to(torch.int64) & _M32)[..., None] >> shifts) & 1
    return b.reshape(*words.shape[:-1], -1).to(torch.float32)


def unpack_bits8(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., 32 W] int8 {0, 1} bits (contiguous)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    b = (words.to(torch.int32)[..., None] >> shifts) & 1
    return b.reshape(*words.shape[:-1], -1).to(torch.int8).contiguous()


def stream_features(words_s: torch.Tensor, words_t: torch.Tensor,
                    na: torch.Tensor, nb: torch.Tensor) -> StreamFeatures:
    """The BSC factors from int32 words (``words_s`` [V, S, W], ``words_t``
    [C, W]) and their popcounts, with the unpacked bit rows."""
    ws, wt = words_s.contiguous(), words_t.contiguous()
    return StreamFeatures(words_s=ws, words_t=wt, na=na, nb=nb,
                          bits_s=unpack_bits8(ws), bits_t=unpack_bits8(wt))


def make_stream_features(packed_s: Optional[torch.Tensor] = None,
                         packed_t: Optional[torch.Tensor] = None,
                         n_bits: int = 441,
                         desc_s: Optional[torch.Tensor] = None,
                         desc_t: Optional[torch.Tensor] = None,
                         standardize: str = "rows"):
    """The streaming lane's factors.  BSC: from packed bits ``packed_s``
    [V, S, W] / ``packed_t`` [V', T, W] (the target uses variant 0), the
    first ``n_bits`` of each row (the words are masked past them).
    FPFH/RoPS: from descriptors ``desc_s`` [S, D] / ``desc_t`` [T, D],
    :func:`make_desc_features` with ``standardize``."""
    if packed_s is None:
        if desc_s is None or desc_t is None:
            raise ValueError("make_stream_features: give packed bits or "
                             "both descriptor sets")
        return make_desc_features(desc_s, desc_t, standardize)
    W = packed_s.shape[-1]
    # each word's bits below n_bits: 32, then what is left, then none
    keep = torch.tensor([(1 << max(0, min(32, n_bits - 32 * w))) - 1
                         for w in range(W)], dtype=torch.int64,
                        device=packed_s.device)
    ws = to_words(packed_s.to(torch.int64) & keep)
    wt = to_words(packed_t[0].to(torch.int64) & keep)
    na = popcount32(ws.to(torch.int64)).sum(dim=-1).to(torch.float32)
    nb = popcount32(wt.to(torch.int64)).sum(dim=-1).to(torch.float32)
    return stream_features(ws, wt, na, nb)


def make_desc_features(desc_s: torch.Tensor, desc_t: torch.Tensor,
                       standardize: str = "rows") -> DescFeatures:
    """Factors of the similarity lane from descriptors [S, D] / [T, D]:
    rows centred and normalised ("rows", Pearson: FPFH), after a
    per-dimension whitening over both sets ("dims": RoPS), zero-padded to
    a multiple of 128 columns, in bf16."""
    from ghicp_tpu_torch.features.fpfh import center_norm
    from ghicp_tpu_torch.features.rops import whiten_dims
    D = desc_s.shape[-1]
    F = -(-D // 128) * 128
    if standardize == "dims":
        desc_s, desc_t = whiten_dims(desc_s, desc_t)
    pad = lambda x: torch.nn.functional.pad(center_norm(x), (0, F - D))
    return DescFeatures(fs=pad(desc_s).to(torch.bfloat16).contiguous(),
                        ft=pad(desc_t).to(torch.bfloat16).contiguous(),
                        dim=D)


def check_features(feats, what: str) -> None:
    """Raise unless ``feats`` is one of the three lanes' factor types."""
    if not isinstance(feats, (StreamFeatures, DescFeatures, NoFeatures)):
        raise TypeError(f"{what}: features must be StreamFeatures, "
                        f"DescFeatures or NoFeatures, got "
                        f"{type(feats).__name__}")


def subset_rows(feats, idx):
    """The source factor rows ``idx`` (an index tensor or a slice; targets
    unchanged); BSC factors, ring factors included, keep the three
    source fields."""
    if isinstance(feats, NoFeatures):
        return NoFeatures(n_rows=len(range(feats.n_rows)[idx])
                          if isinstance(idx, slice) else int(idx.shape[0]))
    if isinstance(feats, DescFeatures):
        return feats._replace(fs=feats.fs[idx].contiguous())
    return feats._replace(words_s=feats.words_s[:, idx].contiguous(),
                          na=feats.na[:, idx],
                          bits_s=feats.bits_s[:, idx].contiguous())


def _ham_block(fs_bits, na, ft_bits, nb_blk) -> torch.Tensor:
    """[S, c] min over variants of |a| + |b| - 2 a.b (exact integers)."""
    fd = None
    for v in range(fs_bits.shape[0]):
        h = (na[v][:, None] + nb_blk[None, :]) - 2.0 * torch.matmul(
            fs_bits[v], ft_bits.T)
        fd = h if fd is None else torch.minimum(fd, h)
    return fd


def _sim_block(fs, ft_blk, dim: int) -> torch.Tensor:
    """[S, c] |fs . ft| summed over the first ``dim`` dimensions in
    increasing order (each bf16 product exact in float32)."""
    a = fs[:, :dim].to(torch.float32)
    b = ft_blk[:, :dim].to(torch.float32)
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    for d in range(dim):
        acc.addcmul_(a[:, d:d + 1], b[None, :, d])
    return acc.abs_()


def _lex_better(va, ja, vb, jb):
    return (va > vb) | ((va == vb) & (ja < jb))


def lex_merge_top2(a, b):
    """The top-2 (v1, j1, v2, j2) of the union of two disjoint column sets
    under (value desc, column asc), from each set's top-2: the same in
    whatever order the sets come (the kernels' ``lex_merge``)."""
    av1, aj1, av2, aj2 = a
    bv1, bj1, bv2, bj2 = b
    bfirst = _lex_better(bv1, bj1, av1, aj1)
    ka = _lex_better(av1, aj1, bv2, bj2)    # a's best second after b's
    kb = _lex_better(bv1, bj1, av2, aj2)    # b's best second after a's
    return (torch.where(bfirst, bv1, av1), torch.where(bfirst, bj1, aj1),
            torch.where(bfirst, torch.where(ka, av1, bv2),
                        torch.where(kb, bv1, av2)),
            torch.where(bfirst, torch.where(ka, aj1, bj2),
                        torch.where(kb, bj1, aj2)))


def _merge_top2(state, v, cols):
    """Fold one block of columns into the running (v1, j1, v2, j2) with
    the lowest column on exact ties: ``v`` [S, c] at the columns ``cols``
    (an offset of c consecutive columns, or [c] increasing ids).  The
    block's top-2 is merged under (value desc, column asc), so blocks may
    come in any order."""
    if isinstance(cols, int):
        cols = cols + torch.arange(v.shape[1], device=v.device)
    m1, a1 = v.max(dim=1)
    vm = v.clone()
    vm.scatter_(1, a1[:, None], NEG)
    m2, a2 = vm.max(dim=1)
    return lex_merge_top2(state, (m1, cols[a1], m2, cols[a2]))


def _top2_init(S: int, dev):
    neg = torch.full((S,), NEG, dtype=torch.float32, device=dev)
    zi = torch.zeros((S,), dtype=torch.int64, device=dev)
    return neg, zi, neg.clone(), zi.clone()


def _col_block(cd, m, rows):
    """([c] least CD over valid rows, [c] the lowest row reaching it) of
    one column block; NO_COL / NO_ROW where a column has no valid row."""
    cdc = torch.where(m, cd, NO_COL)
    cmin = cdc.amin(dim=0)
    crow = torch.where(cdc == cmin[None, :], rows[:, None], NO_ROW).amin(
        dim=0)
    return cmin, torch.where(cmin < NO_COL, crow, NO_ROW)


def stream_sweep_plain(kp_s, kp_t, feats, mask_s, mask_t, prices, acol,
                       wed, wfd, scale, tc: int = PLAIN_TC,
                       col_side: bool = False,
                       with_stats: bool = True,
                       stats64: bool = False) -> SweepResult:
    """Plain PyTorch version of K5: column blocks of ``tc`` (the JAX
    package's ``stream_sweep_ref``), statistics summed in float64; the
    similarity lane when ``feats`` is a :class:`DescFeatures`, the none
    lane for :class:`NoFeatures`; ``col_side`` adds ``cmin`` / ``crow``;
    ``with_stats=False`` returns NaN statistics; ``stats64`` returns the
    count and the two sums in float64 (the ring adds them up)."""
    S, C = kp_s.shape[0], kp_t.shape[0]
    dev = kp_s.device
    ks, kt = _factors(kp_s), _factors(kp_t)
    mult = isinstance(feats, DescFeatures)
    none = isinstance(feats, NoFeatures)
    fs = None if mult or none else unpack_words(feats.words_s)
    acol = acol.to(torch.int64)
    rows = torch.arange(S, device=dev)
    state = _top2_init(S, dev)
    vsel = torch.full((S,), NEG, dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    s1 = torch.zeros((), dtype=torch.float64, device=dev)
    s2 = torch.zeros((), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cmax, emax, fmax = zero, zero, zero
    bmax = torch.full((), NEG, dtype=torch.float32, device=dev)
    col_parts = []
    for off in range(0, C, tc):
        sl = slice(off, min(off + tc, C))
        if none:
            ed = factor_ed(ks, kt[sl], scale)
            cd = torch.tensor(_f32(wed), dtype=torch.float32,
                              device=dev) * ed
            fd = torch.zeros_like(ed)
        elif mult:
            ed, cd = factor_cost(ks, kt[sl], _sim_block(
                feats.fs, feats.ft[sl], feats.dim), wed, wfd, scale, True)
            fd = torch.zeros_like(ed)
        else:
            fd = _ham_block(fs, feats.na,
                            feats.bits_t[sl].to(torch.float32), feats.nb[sl])
            ed, cd = factor_cost(ks, kt[sl], fd, wed, wfd, scale)
        m = mask_s[:, None] & mask_t[None, sl]
        v = torch.where(m, -cd - prices[None, sl], NEG)
        state = _merge_top2(state, v, off)
        cols = torch.arange(sl.start, sl.stop, device=dev)
        vsel = torch.maximum(vsel, torch.where(
            cols[None, :] == acol[:, None], v, NEG).amax(dim=1))
        if col_side:
            col_parts.append(_col_block(cd, m, rows))
        cdm = torch.where(m, cd, 0.0)
        cnt = cnt + m.sum()
        s1 = s1 + cdm.to(torch.float64).sum()
        s2 = s2 + (cdm * cd).to(torch.float64).sum()
        cmax = torch.maximum(cmax, cdm.amax())
        emax = torch.maximum(emax, torch.where(m, ed, 0.0).amax())
        bmax = torch.maximum(bmax, torch.where(m, -cd, NEG).amax())
        fmax = torch.maximum(fmax, torch.where(m, fd, 0.0).amax())
    v1, j1, v2, j2 = state
    f = (lambda x: x.to(torch.float64)) if stats64 else (
        lambda x: x.to(torch.float32))
    cmin = crow = None
    if col_side:
        cmin = torch.cat([c for c, _ in col_parts])
        crow = torch.cat([r for _, r in col_parts])
    res = SweepResult(v1, j1, v2, j2, vsel, f(cnt.to(torch.float64)), f(s1),
                      f(s2), cmax, emax, bmax, fmax, cmin, crow)
    if with_stats:
        return res
    nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
    return res._replace(**{k: nan.to(res.cnt.dtype) if k in STAT_SUMS
                           else nan for k in STAT_FIELDS})


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("stream")
    if not getattr(lib, "_typed", False):
        lib.stream_sweep_tiled.argtypes = ([_I] + [_VP] * 10 + [_I] * 2
                                           + [_VP] * 4 + [_F] * 3
                                           + [_I] * 6 + [_VP] * 13)
        lib.stream_sweep_tiled.restype = _I
        lib._typed = True
    return lib


def _lane(feats) -> int:
    """The kernel entry's lane: 0 none, 1 Hamming, 2 similarity."""
    if isinstance(feats, NoFeatures):
        return 0
    return 2 if isinstance(feats, DescFeatures) else 1


class SweepTarget(NamedTuple):
    """What every sweep of a solve reads of the target unchanged, made once
    by :func:`sweep_target`: the columns' factor rows and int32 mask, the
    lane's target factors in the kernel's forms, the card's SM count, a
    NaN scalar for the statistics a sweep skips, and the identity of the
    tensors it was made from (:func:`check_target`)."""

    kt: torch.Tensor                # [C, 4] float32 (x, y, z, |t|^2)
    mt: torch.Tensor                # [C] int32 mask
    lane: int                       # 0 none, 1 Hamming, 2 similarity
    rows: Optional[torch.Tensor]    # Hamming: [C, 448] int8 bits;
                                    # similarity: [C, F] bf16 rows
    wt: Optional[torch.Tensor]      # Hamming: [C, 14] int32 words
    nb: Optional[torch.Tensor]      # Hamming: [C] float32 popcounts
    n_sm: int
    nan: torch.Tensor               # () float32 NaN
    key: tuple                      # _target_key of its inputs


def _target_key(kp_t, feats, mask_t) -> tuple:
    """The identity of a sweep's target inputs: each tensor's address,
    shape, dtype and version (an in-place write bumps it), for ``kp_t``,
    ``mask_t`` and the lane's target factors."""
    if isinstance(feats, DescFeatures):
        fac = (feats.ft,)
    elif isinstance(feats, StreamFeatures):
        fac = (feats.bits_t, feats.words_t, feats.nb)
    else:
        fac = ()
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype, t._version)
                 if isinstance(t, torch.Tensor) else id(t)
                 for t in (kp_t, mask_t) + fac)


def check_target(target: SweepTarget, kp_t, feats, mask_t) -> None:
    """Raise unless ``target`` was made by :func:`sweep_target` from these
    very tensors, unchanged since."""
    if target.key != _target_key(kp_t, feats, mask_t):
        raise ValueError("stream_sweep: the target was made from other "
                         "columns, factors or mask than this sweep's (or "
                         "they changed since)")


def sweep_target(kp_t, feats, mask_t) -> SweepTarget:
    """The target side of K5's inputs on ``kp_t``'s device, for every sweep
    over these columns, factors and mask (the sweeps of one solve)."""
    check_features(feats, "sweep_target")
    C = kp_t.shape[0]
    dev = kp_t.device
    f32 = torch.float32
    kt = _factors(as_rows(kp_t, C, 3, f32, dev, "kp_t"))
    mt = as_rows(mask_t, C, 0, torch.int32, dev, "mask_t")
    lane = _lane(feats)
    rows = wt = nb = None
    if lane == 2:
        F = feats.ft.shape[1]
        if not 0 < feats.dim <= F or F % 8:
            raise ValueError(f"stream_sweep kernel: dim {feats.dim}, row "
                             f"width {F}")
        rows = as_rows(feats.ft, C, F, torch.bfloat16, dev, "ft")
    elif lane == 1:
        W = feats.words_t.shape[1]
        rows = as_rows(feats.bits_t, C, BIT_ROW, torch.int8, dev, "bits_t")
        wt = as_rows(feats.words_t, C, W, torch.int32, dev, "words_t")
        nb = as_rows(feats.nb, C, 0, f32, dev, "nb")
    n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 1)
    return SweepTarget(kt=kt, mt=mt, lane=lane, rows=rows, wt=wt, nb=nb,
                       n_sm=n_sm, nan=torch.full((), float("nan"), dtype=f32,
                                                 device=dev),
                       key=_target_key(kp_t, feats, mask_t))


def desc_tile_cols(dim: int) -> int:
    """Columns a tile of the similarity kernel: 128 at FPFH's D = 33 (its
    own instantiation), 64 at any other D."""
    return 128 if dim == 33 else 64


def lane_tile(feats) -> tuple:
    """(rows a block, columns a tile) of the kernel of ``feats``' lane."""
    if isinstance(feats, NoFeatures):
        return NONE_RT, NONE_TC
    if isinstance(feats, DescFeatures):
        return DESC_RT, desc_tile_cols(feats.dim)
    return RT, HAM_TC


def column_splits(S: int, C: int, n_sm: int, rows: int, cols: int,
                  per_sm: int) -> int:
    """Column ranges a row block of ``rows`` is split into (tiles of
    ``cols``), so that short row sets (compacted sweeps) still give every
    SM ``per_sm`` blocks; no range is left empty."""
    n_rt = -(-S // rows)
    n_ct = -(-C // cols)
    cs = max(1, min(n_ct, -(-per_sm * n_sm // n_rt)))
    return -(-n_ct // -(-n_ct // cs))


# The kernels' grids hold ~16 blocks an SM (split over columns when the
# rows are few): the last wave of equal blocks then leaves at most about a
# sixteenth of the card idle.
_TILED_PER_SM = 16


def stream_sweep_cuda(kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed,
                      wfd, scale, col_side: bool = False,
                      with_stats: bool = True,
                      target: Optional[SweepTarget] = None,
                      stats64: bool = False) -> SweepResult:
    """Launch K5 on the card, the lane of ``feats``' type, with or without
    its column side; ``target`` (made by :func:`sweep_target` from these
    columns, factors and mask, else raises) skips redoing the target's
    inputs; without one the call makes it.  The
    source rows go to the kernel as they are (it computes their norms), and
    the statistics are reduced only when asked for."""
    from ghicp_tpu_torch.ops._build import check
    S, C = kp_s.shape[0], kp_t.shape[0]
    dev = kp_s.device
    f32, i64 = torch.float32, torch.int64
    lane = _lane(feats)
    if target is None:
        target = sweep_target(kp_t, feats, mask_t)
    else:
        check_target(target, kp_t, feats, mask_t)
    bs = ws = na = fs = None
    V = D = F = 0
    if lane == 1:
        V, _, W = feats.words_s.shape
        if W != BIT_ROW // 32 or not 1 <= V <= KERNEL_MAX_VARIANTS:
            raise ValueError(f"stream_sweep kernel: (V, W) = ({V}, {W}); "
                             f"it takes W = {BIT_ROW // 32} and 1 <= V <= "
                             f"{KERNEL_MAX_VARIANTS}")
        ws = as_rows(feats.words_s.reshape(V * S, W), V * S, W, torch.int32,
                     dev, "words_s")
        bs = feats.bits_s.to(device=dev, dtype=torch.int8).contiguous()
        if tuple(bs.shape) != (V, S, BIT_ROW):
            raise ValueError(f"bits_s: expected {(V, S, BIT_ROW)}, got "
                             f"{tuple(bs.shape)}")
        na = feats.na.to(device=dev, dtype=f32).contiguous()
    elif lane == 2:
        D, F = feats.dim, target.rows.shape[1]
        fs = as_rows(feats.fs, S, F, torch.bfloat16, dev, "fs")
    ks = as_rows(kp_s, S, 3, f32, dev, "kp_s")     # |s|^2 in the kernel
    ms = as_rows(mask_s, S, 0, torch.bool, dev, "mask_s")
    p = as_rows(prices, C, 0, f32, dev, "prices")
    ac = as_rows(acol, S, 0, i64, dev, "acol")
    rows, cols = lane_tile(feats)
    cs = column_splits(S, C, target.n_sm, rows, cols, _TILED_PER_SM)
    n_blocks = -(-S // rows) * cs
    vf = torch.empty((3, S), dtype=f32, device=dev)   # v1, v2, vsel
    vj = torch.empty((2, S), dtype=i64, device=dev)   # j1, j2
    if cs > 1:
        pf = torch.empty((3, cs, S), dtype=f32, device=dev)
        pj = torch.empty((2, cs, S), dtype=i64, device=dev)
    else:
        pf, pj = vf, vj
    keep_stats = with_stats or col_side
    stats = (torch.empty((n_blocks, 8), dtype=torch.float64, device=dev)
             if keep_stats else None)
    colkey = (torch.full((C,), _COL_KEY0, dtype=i64, device=dev)
              if col_side else None)
    # raw addresses (ctypes takes ints and None for c_void_p; the outputs'
    # rows by offset) and Python floats (c_float rounds them to float32, as
    # the plain version's float32 tensors do): no object a pointer
    ad = lambda t: None if t is None else t.data_ptr()
    fb, jb = vf.data_ptr(), vj.data_ptr()
    pfb, pjb = pf.data_ptr(), pj.data_ptr()
    rc = _lib().stream_sweep_tiled(
        lane, ad(ks), ad(target.kt), ad(bs), ad(ws),
        ad(target.rows if lane == 1 else None), ad(target.wt), ad(na),
        ad(target.nb), ad(fs), ad(target.rows if lane == 2 else None), D, F,
        ad(ms), ad(target.mt), ad(p), ad(ac), float(wed), float(wfd),
        float(scale), S, C, V, cs, n_blocks, int(with_stats),
        fb, jb, fb + 4 * S, jb + 8 * S, fb + 8 * S,
        pfb, pjb, pfb + 4 * cs * S, pjb + 8 * cs * S, pfb + 8 * cs * S,
        ad(stats), ad(colkey), torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "stream_sweep launch")
    name = ("stream_sweep_mult" if lane == 2 else "stream_sweep_none"
            if lane == 0 else "stream_sweep")
    name = name + "_col" if col_side else name
    count_launch(name)
    count_launch(f"{name}@{S}")
    cmin = crow = None
    if col_side:
        cmin = (colkey >> 32).to(torch.int32).view(f32)
        crow = colkey & _M32
    if with_stats:
        tot = stats[:, :3].sum(dim=0)
        tot = tot if stats64 else tot.to(f32)
        mx = stats[:, 3:7].amax(dim=0).to(f32)
    else:
        tot = (target.nan.to(torch.float64) if stats64 else target.nan,) * 3
        mx = (target.nan,) * 4
    return SweepResult(vf[0], vj[0], vf[1], vj[1], vf[2], tot[0], tot[1],
                       tot[2], mx[0], mx[1], mx[2], mx[3], cmin, crow)


def stream_sweep(kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed, wfd,
                 scale, col_side: bool = False, with_stats: bool = True,
                 target: Optional[SweepTarget] = None,
                 stats64: bool = False) -> SweepResult:
    """One matrix-free sweep: per-row top-2 of (b - p), vsel at ``acol``
    and the CD statistics.  kp_s [S, 3] / kp_t [C, 3] float32, centred by
    a common offset; ``prices`` [C]; ``acol`` [S] previous column, SINK or
    -1.  The features' type picks the lane: :class:`StreamFeatures` the
    BSC lane, :class:`DescFeatures` the FPFH/RoPS (multiplicative blend)
    lane with k in ``wfd``, :class:`NoFeatures` the none lane; any other
    type raises.  ``col_side`` adds the per-column least CD and its lowest
    row.  ``with_stats=False`` (the bidding sweeps, which read the top-2
    only) skips the statistics and returns them as NaN.  ``target``
    (:func:`sweep_target` of ``kp_t``, ``feats`` and ``mask_t``) carries
    what the kernel reads of the target, made once for many sweeps.  CUDA
    tensors run the kernel, CPU tensors the plain version (which needs no
    ``target``).  ``stats64`` returns the count and the two sums in
    float64."""
    check_features(feats, "stream_sweep")
    if isinstance(feats, NoFeatures) and feats.n_rows != kp_s.shape[0]:
        raise ValueError(f"stream_sweep: NoFeatures of {feats.n_rows} rows "
                         f"for {kp_s.shape[0]} source rows")
    args = (kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed, wfd, scale)
    kw = dict(col_side=col_side, with_stats=with_stats, stats64=stats64)
    if require_device(kp_s, "stream_sweep") == "cuda":
        return stream_sweep_cuda(*args, **kw, target=target)
    return stream_sweep_plain(*args, **kw)


class RingFeatures(NamedTuple):
    """The BSC factors of the ring lane on one rank: this rank's source
    rows, and of the target the block of int8 bit rows the rank holds at
    the start of a sweep (block r of ``C / n`` rows, the form K5 reads,
    passed around the ring); the target's packed words and popcounts stay
    replicated (the matched-pair gathers read the words, 1/14 of the
    bits' bytes)."""

    words_s: torch.Tensor   # [V, S_r, W] int32 source bits (this rank)
    na: torch.Tensor        # [V, S_r] float32 popcounts
    bits_s: torch.Tensor    # [V, S_r, 448] int8
    bits_blk: torch.Tensor  # [C / n, 448] int8 target block r
    words_t: torch.Tensor   # [C, W] int32, every rank
    nb: torch.Tensor        # [C] float32, every rank


def ring_features(feats: StreamFeatures, rows: slice, rank: int,
                  n: int) -> RingFeatures:
    """Rank ``rank`` of ``n``'s :class:`RingFeatures` from the whole
    factors: its source ``rows`` and its target block."""
    C = feats.bits_t.shape[0]
    if C % n:
        raise ValueError(f"column count {C} not divisible by {n} ranks")
    c = C // n
    src = subset_rows(feats, rows)
    return RingFeatures(
        words_s=src.words_s, na=src.na, bits_s=src.bits_s,
        bits_blk=feats.bits_t[rank * c:(rank + 1) * c].contiguous(),
        words_t=feats.words_t, nb=feats.nb)


class RingTarget(NamedTuple):
    """What every ring step reads of the replicated target, made once a
    solve (:func:`ring_target`): the columns' factor rows, int32 mask,
    words and popcounts on the card, sliced per step."""

    kt: torch.Tensor
    mt: torch.Tensor
    wt: torch.Tensor
    nb: torch.Tensor
    n_sm: int
    nan: torch.Tensor


def ring_target(kp_t, ring: RingFeatures, mask_t) -> RingTarget:
    C = kp_t.shape[0]
    base = sweep_target(kp_t, NoFeatures(n_rows=0), mask_t)
    W = ring.words_t.shape[1]
    dev = kp_t.device
    return RingTarget(kt=base.kt, mt=base.mt,
                      wt=as_rows(ring.words_t, C, W, torch.int32, dev,
                                 "words_t"),
                      nb=as_rows(ring.nb, C, 0, torch.float32, dev, "nb"),
                      n_sm=base.n_sm, nan=base.nan)


def _ring_step(kp_s, kp_t, ring, mask_s, mask_t, prices, acol, blk, off,
               rt: Optional[RingTarget]):
    """One step's sweep arguments: the block's columns ``off`` ... as
    views of the replicated target, the held bit rows ``blk``, and the
    step's ``SweepTarget`` from those views (no unpacking)."""
    sl = slice(off, off + blk.shape[0])
    kpt, mt = kp_t[sl], mask_t[sl]
    words, nb = (ring.words_t, ring.nb) if rt is None else (rt.wt, rt.nb)
    sub = StreamFeatures(words_s=ring.words_s, words_t=words[sl],
                         na=ring.na, nb=nb[sl], bits_s=ring.bits_s,
                         bits_t=blk)
    acl = torch.where((acol >= off) & (acol < sl.stop), acol - off, -1)
    target = None
    if rt is not None:
        target = SweepTarget(kt=rt.kt[sl], mt=rt.mt[sl], lane=1, rows=blk,
                             wt=sub.words_t, nb=sub.nb, n_sm=rt.n_sm,
                             nan=rt.nan, key=_target_key(kpt, sub, mt))
    return (kp_s, kpt, sub, mask_s, mt, prices[sl], acl), target


def ring_sweep(kp_s, kp_t, ring: RingFeatures, mask_s, mask_t, prices,
               acol, wed, wfd, scale, comm, with_stats: bool = True,
               target: Optional[RingTarget] = None) -> SweepResult:
    """One matrix-free sweep with the target's factor blocks rotated around
    the ring of ``comm``'s ranks: step s sweeps this rank's rows against
    block (rank + s) mod n with K5 (global column ids), while the held
    block travels to rank - 1 (n - 1 transfers a
    sweep: the last step keeps its block).  The top-2 merge keeps the
    lowest column on ties, so the result is one sweep's over the whole
    target; the count and sums are added in float64 (only their order
    differs from one sweep's).  Hamming (BSC) lane, any row count.
    ``target`` (:func:`ring_target`) is made once a solve; on the card
    without one each sweep makes it."""
    C = kp_t.shape[0]
    c_blk = ring.bits_blk.shape[0]
    n = comm.axis_size()
    if c_blk * n != C:
        raise ValueError(f"ring_sweep: {n} blocks of {c_blk} columns for "
                         f"{C} columns")
    S = kp_s.shape[0]
    dev = kp_s.device
    cuda = require_device(kp_s, "ring_sweep") == "cuda"
    if cuda and target is None:
        target = ring_target(kp_t, ring, mask_t)
    acol = acol.to(torch.int64)
    state = _top2_init(S, dev)
    vsel = torch.full((S,), NEG, dtype=torch.float32, device=dev)
    sums = maxs = None
    blk = ring.bits_blk
    for step in range(n):
        pending = comm.ppermute_start(blk) if step < n - 1 else None
        off = ((comm.axis_index() + step) % n) * c_blk
        args, tg = _ring_step(kp_s, kp_t, ring, mask_s, mask_t, prices, acol,
                              blk, off, target if cuda else None)
        if cuda:
            sw = stream_sweep_cuda(*args, wed, wfd, scale,
                                   with_stats=with_stats, target=tg,
                                   stats64=True)
        else:
            sw = stream_sweep_plain(*args, wed, wfd, scale,
                                    with_stats=with_stats, stats64=True)
        state = lex_merge_top2(state, (sw.v1, sw.j1 + off, sw.v2,
                                       sw.j2 + off))
        vsel = torch.maximum(vsel, sw.vsel)
        s3 = torch.stack([sw.cnt, sw.cd_sum, sw.cd_sumsq])
        m4 = torch.stack([sw.cd_max, sw.ed_max, sw.b_max, sw.fd_max])
        sums = s3 if sums is None else sums + s3
        maxs = m4 if maxs is None else torch.maximum(maxs, m4)
        if pending is not None:
            blk = pending.wait()
    if cuda:
        count_launch("ring_sweep")
    v1, j1, v2, j2 = state
    tot = sums.to(torch.float32)
    return SweepResult(v1, j1, v2, j2, vsel, tot[0], tot[1], tot[2],
                       *maxs.unbind())


def ring_selected(kp_s, kp_t, ring: RingFeatures, tgt_idx, wed, wfd, scale):
    """(cd_sel, ed_sel, fd_sel) at the matched pairs from the replicated
    packed words (no ring traffic): :func:`stream_selected`."""
    feats = StreamFeatures(words_s=ring.words_s, words_t=ring.words_t,
                           na=ring.na, nb=ring.nb, bits_s=ring.bits_s,
                           bits_t=ring.bits_blk)
    return stream_selected(kp_s, kp_t, feats, tgt_idx, wed, wfd, scale)


def stream_selected(kp_s, kp_t, feats, tgt_idx, wed, wfd, scale):
    """(cd_sel, ed_sel, fd_sel) [S] at the pairs (i, tgt_idx[i]) from
    factor gathers: ED by the direct norm, FD by XOR popcounts, or on the
    similarity lane the similarity |fs_i . ft_j| and the multiplicative
    blend; with :class:`NoFeatures` FD = 0 and CD = W_ED * ED."""
    check_features(feats, "stream_selected")
    dev = kp_s.device
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=dev)
    tgt_idx = tgt_idx.to(torch.int64)
    ed = f(scale) * torch.linalg.norm(kp_s - kp_t[tgt_idx], dim=-1)
    if isinstance(feats, NoFeatures):
        return f(wed) * ed, ed, torch.zeros_like(ed)
    if isinstance(feats, DescFeatures):
        fd = torch.abs((feats.fs.to(torch.float32)
                        * feats.ft[tgt_idx].to(torch.float32)).sum(dim=-1))
        return mult_cost(ed, fd, f(wfd)), ed, fd
    x = (feats.words_s.to(torch.int64)
         ^ feats.words_t[tgt_idx].to(torch.int64)[None])
    fd = popcount32(x).sum(dim=-1).amin(dim=0).to(torch.float32)
    return f(wed) * ed + f(wfd) * fd, ed, fd


def stream_feature_candidates(feats, mask_s, mask_t, tc: int = PLAIN_TC):
    """Top-2 feature-nearest target columns per source row, matrix-free:
    column blocks of -Hamming (max over variants), or of the similarity
    |fs . ft| (:class:`DescFeatures`; a float32 product
    of the bf16 rows).  Returns (cand [S, 2] int64, cand_ok [S, 2] bool)."""
    S, C = mask_s.shape[0], mask_t.shape[0]
    dev = mask_s.device
    mult = isinstance(feats, DescFeatures)
    if mult:
        a = feats.fs.to(torch.float32)
    else:
        fs = unpack_words(feats.words_s)
    state = _top2_init(S, dev)
    for off in range(0, C, tc):
        sl = slice(off, min(off + tc, C))
        if mult:
            v = torch.abs(torch.matmul(a, feats.ft[sl].to(torch.float32).T))
        else:
            v = -_ham_block(fs, feats.na, unpack_words(feats.words_t[sl]),
                            feats.nb[sl])
        v = torch.where(mask_s[:, None] & mask_t[None, sl], v, NEG)
        state = _merge_top2(state, v, off)
    v1, j1, v2, j2 = state
    cand = torch.stack([j1, j2], dim=1)
    cand_ok = torch.stack([v1 > NEG, v2 > NEG], dim=1) & mask_s[:, None]
    return cand, cand_ok
