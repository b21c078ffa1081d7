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
over valid pairs.  The features stay packed: 32 bits a word, ``W`` words a
row (14 for the 441 BSC bits).  For {0, 1} bits, |a| + |b| - 2 a.b =
popc(a XOR b) exactly, so the plain version's float32 product of the
unpacked bits and the kernel's XOR + POPC give the same integers.  On
the similarity lane a product of two bf16 values is exact in float32, so
only the order of the sum over the D dimensions matters: both versions
add them in increasing order, and the plain one never calls a matrix
product, whose order is its own.

Bound on this card: integer operations on the Hamming lane, V * W * (XOR
+ POPC + add) a pair; float operations on the similarity lane, 2 D a pair
plus the blend; on the feature-"none" lane (:class:`NoFeatures`, no
factor is read, CD = W_ED * ED) the float operations of ED, the blend,
the top-2 and the statistics.  The bytes (coordinates and factors, read
once) are a few MB.  ``col_side`` (every lane; the reciprocal-NN matcher)
adds per column the least CD over valid rows and the lowest row that
reaches it (``cmin`` / ``crow``).  The design notes are at the head of the
CUDA source.  Every variant counts its launches under its own name
(``stream_sweep``, ``stream_sweep_mult``, ``stream_sweep_none``, each with
a ``_col`` twin).

:func:`stream_selected` (matched-pair gathers),
:func:`stream_feature_candidates` (the RANSAC candidates; a ``lax.scan``
in the JAX package, not a kernel) and :func:`make_desc_features` are plain
PyTorch on either device.
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
RT = 128        # rows a block of the kernel (the compaction granule)
TC = 128        # columns a staged tile of the kernel
PLAIN_TC = 1024
_KERNEL_SHAPES = {(1, 14), (2, 14), (4, 14)}    # (V, W) instantiated
_M32 = 0xFFFFFFFF


class StreamFeatures(NamedTuple):
    """Packed factor representation of the BSC feature distance."""

    words_s: torch.Tensor   # [V, S, W] int32 source bits (variants)
    words_t: torch.Tensor   # [C, W] int32 target bits (variant 0)
    na: torch.Tensor        # [V, S] float32 popcounts
    nb: torch.Tensor        # [C] float32 popcounts


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


def make_stream_features(packed_s: torch.Tensor,
                         packed_t: torch.Tensor) -> StreamFeatures:
    """Factors from packed BSC bits (zero beyond the last bit):
    ``packed_s`` [V, S, W], ``packed_t`` [V', T, W] (the target uses
    variant 0)."""
    ws, wt = to_words(packed_s), to_words(packed_t[0])
    na = popcount32(ws.to(torch.int64)).sum(dim=-1).to(torch.float32)
    nb = popcount32(wt.to(torch.int64)).sum(dim=-1).to(torch.float32)
    return StreamFeatures(words_s=ws.contiguous(), words_t=wt.contiguous(),
                          na=na, nb=nb)


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


def subset_rows(feats, idx: torch.Tensor):
    """The source factor rows ``idx`` (targets unchanged)."""
    if isinstance(feats, NoFeatures):
        return NoFeatures(n_rows=int(idx.shape[0]))
    if isinstance(feats, DescFeatures):
        return feats._replace(fs=feats.fs[idx].contiguous())
    return feats._replace(words_s=feats.words_s[:, idx].contiguous(),
                          na=feats.na[:, idx])


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


def _merge_top2(state, v, off: int):
    """Fold one column block's values into the running (v1, j1, v2, j2),
    in the JAX package's order (lowest column on exact ties)."""
    v1, j1, v2, j2 = state
    cols = off + torch.arange(v.shape[1], device=v.device)
    m1, a1 = v.max(dim=1)
    a1 = a1 + off
    vm = torch.where(cols[None, :] == a1[:, None], NEG, v)
    m2, a2 = vm.max(dim=1)
    a2 = a2 + off
    take = (m1 > v1) | ((m1 == v1) & (a1 < j1))
    nv1 = torch.maximum(v1, m1)
    nj1 = torch.where(take, a1, j1)
    nv2 = torch.maximum(torch.minimum(v1, m1), torch.maximum(v2, m2))
    nj2 = torch.where(take, torch.where(v1 >= m2, j1, a2),
                      torch.where(m1 > v2, a1, j2))
    return nv1, nj1, nv2, nj2


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
                       col_side: bool = False) -> SweepResult:
    """Plain PyTorch version of K5: column blocks of ``tc`` (the JAX
    package's ``stream_sweep_ref``), statistics summed in float64; the
    similarity lane when ``feats`` is a :class:`DescFeatures`, the none
    lane for :class:`NoFeatures`; ``col_side`` adds ``cmin`` / ``crow``."""
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
            fd = _ham_block(fs, feats.na, unpack_words(feats.words_t[sl]),
                            feats.nb[sl])
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
    f = lambda x: x.to(torch.float32)
    cmin = crow = None
    if col_side:
        cmin = torch.cat([c for c, _ in col_parts])
        crow = torch.cat([r for _, r in col_parts])
    return SweepResult(v1, j1, v2, j2, vsel, f(cnt.to(torch.float64)), f(s1),
                       f(s2), cmax, emax, bmax, fmax, cmin, crow)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("stream")
    if not getattr(lib, "_typed", False):
        lib.stream_sweep.argtypes = ([_VP] * 8 + [_F] * 3 + [_I] * 6
                                     + [_VP] * 13)
        lib.stream_sweep.restype = _I
        lib.stream_sweep_desc.argtypes = ([_VP] * 4 + [_I] * 2 + [_VP] * 4
                                          + [_F] * 2 + [_I] * 4
                                          + [_VP] * 13)
        lib.stream_sweep_desc.restype = _I
        lib._typed = True
    return lib


def column_splits(S: int, C: int, n_sm: int) -> int:
    """Column ranges a row block is split into, so that short row sets
    (compacted sweeps) still give every SM two blocks."""
    n_rt = -(-S // RT)
    n_ct = -(-C // TC)
    return max(1, min(n_ct, -(-2 * n_sm // n_rt)))


def stream_sweep_cuda(kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed,
                      wfd, scale, col_side: bool = False) -> SweepResult:
    """Launch K5 on the card (the similarity lane for a
    :class:`DescFeatures`, the none lane for :class:`NoFeatures`)."""
    from ghicp_tpu_torch.ops._build import check, ptr
    S, C = kp_s.shape[0], kp_t.shape[0]
    dev = kp_s.device
    f32, i32 = torch.float32, torch.int32
    mult = isinstance(feats, DescFeatures)
    if mult:
        F = feats.fs.shape[1]
        if not 0 < feats.dim <= F or F % 8:
            raise ValueError(f"stream_sweep kernel: dim {feats.dim}, row "
                             f"width {F}")
        fs = as_rows(feats.fs, S, F, torch.bfloat16, dev, "fs")
        ft = as_rows(feats.ft, C, F, torch.bfloat16, dev, "ft")
    elif isinstance(feats, NoFeatures):
        V = W = 0
        ws = wt = None
    else:
        V, _, W = feats.words_s.shape
        if (V, W) not in _KERNEL_SHAPES:
            raise ValueError(f"stream_sweep kernel: (V, W) = ({V}, {W}) not "
                             f"in {sorted(_KERNEL_SHAPES)}")
        ws = feats.words_s.to(device=dev, dtype=i32).contiguous()
        wt = as_rows(feats.words_t, C, W, i32, dev, "words_t")
    ks = _factors(as_rows(kp_s, S, 3, f32, dev, "kp_s"))
    kt = _factors(as_rows(kp_t, C, 3, f32, dev, "kp_t"))
    ms = as_rows(mask_s, S, 0, i32, dev, "mask_s")
    mt = as_rows(mask_t, C, 0, i32, dev, "mask_t")
    p = as_rows(prices, C, 0, f32, dev, "prices")
    ac = as_rows(torch.clamp(acol.to(torch.int64), -1, 2**31 - 1), S, 0, i32,
                 dev, "acol")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cs = column_splits(S, C, n_sm)
    v1 = torch.empty((S,), dtype=f32, device=dev)
    j1 = torch.empty((S,), dtype=i32, device=dev)
    v2 = torch.empty((S,), dtype=f32, device=dev)
    j2 = torch.empty((S,), dtype=i32, device=dev)
    vsel = torch.empty((S,), dtype=f32, device=dev)
    if cs > 1:
        parts = [torch.empty((cs, S), dtype=t, device=dev)
                 for t in (f32, i32, f32, i32, f32)]
    else:
        parts = [v1, j1, v2, j2, vsel]
    n_blocks = -(-S // RT) * cs
    stats = torch.empty((n_blocks, 8), dtype=torch.float64, device=dev)
    colkey = (torch.full((C,), _COL_KEY0, dtype=torch.int64, device=dev)
              if col_side else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp = lambda t: _VP(None) if t is None else ptr(t)
    outs = (ptr(v1), ptr(j1), ptr(v2), ptr(j2), ptr(vsel),
            *[ptr(t) for t in parts], ptr(stats), vp(colkey), _VP(stream))
    if mult:
        rc = _lib().stream_sweep_desc(
            ptr(ks), ptr(kt), ptr(fs), ptr(ft), feats.dim, F, ptr(ms),
            ptr(mt), ptr(p), ptr(ac), _f32(wfd), _f32(scale), S, C, cs,
            n_blocks, *outs)
    else:
        rc = _lib().stream_sweep(
            ptr(ks), ptr(kt), vp(ws), vp(wt), ptr(ms), ptr(mt), ptr(p),
            ptr(ac), _f32(wed), _f32(wfd), _f32(scale), S, C, V, W, cs,
            n_blocks, *outs)
    check(rc, "stream_sweep launch")
    name = ("stream_sweep_mult" if mult else "stream_sweep_none"
            if V == 0 else "stream_sweep")
    count_launch(name + "_col" if col_side else name)
    tot = stats[:, :3].sum(dim=0).to(f32)
    mx = stats[:, 3:7].amax(dim=0).to(f32)
    cmin = crow = None
    if col_side:
        cmin = (colkey >> 32).to(i32).view(f32)
        crow = colkey & _M32
    return SweepResult(v1, j1.to(torch.int64), v2, j2.to(torch.int64), vsel,
                       tot[0], tot[1], tot[2], mx[0], mx[1], mx[2], mx[3],
                       cmin, crow)


def stream_sweep(kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed, wfd,
                 scale, col_side: bool = False) -> SweepResult:
    """One matrix-free sweep: per-row top-2 of (b - p), vsel at ``acol``
    and the CD statistics.  kp_s [S, 3] / kp_t [C, 3] float32, centred by
    a common offset; ``prices`` [C]; ``acol`` [S] previous column, SINK or
    -1.  The features' type picks the lane: :class:`StreamFeatures` the
    BSC lane, :class:`DescFeatures` the FPFH/RoPS (multiplicative blend)
    lane with k in ``wfd``, :class:`NoFeatures` the none lane; any other
    type raises.  ``col_side`` adds the per-column least CD and its lowest
    row.  CUDA tensors run the kernel, CPU tensors the plain version."""
    check_features(feats, "stream_sweep")
    if isinstance(feats, NoFeatures) and feats.n_rows != kp_s.shape[0]:
        raise ValueError(f"stream_sweep: NoFeatures of {feats.n_rows} rows "
                         f"for {kp_s.shape[0]} source rows")
    args = (kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed, wfd, scale)
    if require_device(kp_s, "stream_sweep") == "cuda":
        return stream_sweep_cuda(*args, col_side=col_side)
    return stream_sweep_plain(*args, col_side=col_side)


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
