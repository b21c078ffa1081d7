"""Matrix-free streaming cost sweep (kernel K5), CUDA C++ in
``csrc/stream.cu``, with its plain PyTorch version.

Replaces ``ghicp_tpu/ops/stream_kernel.py::stream_sweep`` (Pallas
``_kernel``) on its Hamming (BSC) lane.  One sweep computes, for every
source row against every target column, without materializing [S, C]:

  ED = scale * sqrt(max(|s|^2 + |t|^2 - 2 s.t, 0))   (fixed product order)
  FD = min over the V source variants of popc(a_v XOR b)
  CD = W_ED * ED + W_FD * FD;  v = -CD - p[j] at valid pairs

and keeps per row the top-2 of v (v1, j1, v2, j2; the lowest column on
exact ties), v at the previous assignment ``acol`` (vsel), and the
statistics count, sum CD, sum CD^2, max CD, max ED, max -CD and max FD
over valid pairs.  The features stay packed: 32 bits a word, ``W`` words a
row (14 for the 441 BSC bits).  For {0, 1} bits, |a| + |b| - 2 a.b =
popc(a XOR b) exactly, so the plain version's float32 product of the
unpacked bits and the kernel's XOR + POPC give the same integers.

Bound on this card: integer operations, V * W * (XOR + POPC + add) a pair;
the bytes (coordinates and packed words, read once) are a few MB.  The
design notes are at the head of the CUDA source.  The multiplicative
(FPFH/RoPS) blend, the feature-"none" lane and the column-side reduction
of the NNR matcher are not ported yet: the wrapper raises for them.

:func:`stream_selected` (matched-pair gathers) and
:func:`stream_feature_candidates` (the RANSAC candidates; a ``lax.scan``
in the JAX package, not a kernel) are plain PyTorch on either device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ghicp_tpu_torch.ops import as_rows, count_launch, require_device
from ghicp_tpu_torch.ops.cost_kernel import _f32, _factors, factor_cost

NEG = -3.0e38
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


def subset_rows(feats: StreamFeatures, idx: torch.Tensor) -> StreamFeatures:
    """The source factor rows ``idx`` (targets unchanged)."""
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


def stream_sweep_plain(kp_s, kp_t, feats: StreamFeatures, mask_s, mask_t,
                       prices, acol, wed, wfd, scale,
                       tc: int = PLAIN_TC) -> SweepResult:
    """Plain PyTorch version of K5: column blocks of ``tc`` (the JAX
    package's ``stream_sweep_ref``), statistics summed in float64."""
    S, C = kp_s.shape[0], kp_t.shape[0]
    dev = kp_s.device
    ks, kt = _factors(kp_s), _factors(kp_t)
    fs = unpack_words(feats.words_s)
    acol = acol.to(torch.int64)
    state = _top2_init(S, dev)
    vsel = torch.full((S,), NEG, dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    s1 = torch.zeros((), dtype=torch.float64, device=dev)
    s2 = torch.zeros((), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cmax, emax, fmax = zero, zero, zero
    bmax = torch.full((), NEG, dtype=torch.float32, device=dev)
    for off in range(0, C, tc):
        sl = slice(off, min(off + tc, C))
        fd = _ham_block(fs, feats.na, unpack_words(feats.words_t[sl]),
                        feats.nb[sl])
        ed, cd = factor_cost(ks, kt[sl], fd, wed, wfd, scale)
        m = mask_s[:, None] & mask_t[None, sl]
        v = torch.where(m, -cd - prices[None, sl], NEG)
        state = _merge_top2(state, v, off)
        cols = torch.arange(sl.start, sl.stop, device=dev)
        vsel = torch.maximum(vsel, torch.where(
            cols[None, :] == acol[:, None], v, NEG).amax(dim=1))
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
    return SweepResult(v1, j1, v2, j2, vsel, f(cnt.to(torch.float64)), f(s1),
                       f(s2), cmax, emax, bmax, fmax)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("stream")
    if not getattr(lib, "_typed", False):
        lib.stream_sweep.argtypes = ([_VP] * 8 + [_F] * 3 + [_I] * 6
                                     + [_VP] * 12)
        lib.stream_sweep.restype = _I
        lib._typed = True
    return lib


def column_splits(S: int, C: int, n_sm: int) -> int:
    """Column ranges a row block is split into, so that short row sets
    (compacted sweeps) still give every SM two blocks."""
    n_rt = -(-S // RT)
    n_ct = -(-C // TC)
    return max(1, min(n_ct, -(-2 * n_sm // n_rt)))


def stream_sweep_cuda(kp_s, kp_t, feats: StreamFeatures, mask_s, mask_t,
                      prices, acol, wed, wfd, scale) -> SweepResult:
    """Launch K5 on the card."""
    from ghicp_tpu_torch.ops._build import check, ptr
    S, C = kp_s.shape[0], kp_t.shape[0]
    V, _, W = feats.words_s.shape
    if (V, W) not in _KERNEL_SHAPES:
        raise ValueError(f"stream_sweep kernel: (V, W) = ({V}, {W}) not in "
                         f"{sorted(_KERNEL_SHAPES)}")
    dev = kp_s.device
    f32, i32 = torch.float32, torch.int32
    ks = _factors(as_rows(kp_s, S, 3, f32, dev, "kp_s"))
    kt = _factors(as_rows(kp_t, C, 3, f32, dev, "kp_t"))
    ws = feats.words_s.to(device=dev, dtype=i32).contiguous()
    wt = as_rows(feats.words_t, C, W, i32, dev, "words_t")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().stream_sweep(
        ptr(ks), ptr(kt), ptr(ws), ptr(wt), ptr(ms), ptr(mt), ptr(p),
        ptr(ac), _f32(wed), _f32(wfd), _f32(scale), S, C, V, W, cs,
        n_blocks, ptr(v1), ptr(j1), ptr(v2), ptr(j2), ptr(vsel),
        *[ptr(t) for t in parts], ptr(stats), _VP(stream))
    check(rc, "stream_sweep launch")
    count_launch("stream_sweep")
    tot = stats[:, :3].sum(dim=0).to(f32)
    mx = stats[:, 3:7].amax(dim=0).to(f32)
    return SweepResult(v1, j1.to(torch.int64), v2, j2.to(torch.int64), vsel,
                       tot[0], tot[1], tot[2], mx[0], mx[1], mx[2], mx[3])


def stream_sweep(kp_s, kp_t, feats: StreamFeatures, mask_s, mask_t, prices,
                 acol, wed, wfd, scale, mult_blend: bool = False,
                 no_features: bool = False,
                 col_side: bool = False) -> SweepResult:
    """One matrix-free sweep: per-row top-2 of (b - p), vsel at ``acol``
    and the CD statistics.  kp_s [S, 3] / kp_t [C, 3] float32, centred by
    a common offset; ``prices`` [C]; ``acol`` [S] previous column, SINK or
    -1.  CUDA tensors run the kernel, CPU tensors the plain version."""
    if mult_blend or no_features or col_side:
        raise NotImplementedError(
            "stream_sweep: only the Hamming (BSC) lane is ported; "
            "mult_blend, no_features and col_side are still to port")
    args = (kp_s, kp_t, feats, mask_s, mask_t, prices, acol, wed, wfd, scale)
    if require_device(kp_s, "stream_sweep") == "cuda":
        return stream_sweep_cuda(*args)
    return stream_sweep_plain(*args)


def stream_selected(kp_s, kp_t, feats: StreamFeatures, tgt_idx, wed, wfd,
                    scale):
    """(cd_sel, ed_sel, fd_sel) [S] at the pairs (i, tgt_idx[i]) from
    factor gathers: ED by the direct norm, FD by XOR popcounts."""
    dev = kp_s.device
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=dev)
    tgt_idx = tgt_idx.to(torch.int64)
    ed = f(scale) * torch.linalg.norm(kp_s - kp_t[tgt_idx], dim=-1)
    x = (feats.words_s.to(torch.int64)
         ^ feats.words_t[tgt_idx].to(torch.int64)[None])
    fd = popcount32(x).sum(dim=-1).amin(dim=0).to(torch.float32)
    return f(wed) * ed + f(wfd) * fd, ed, fd


def stream_feature_candidates(feats: StreamFeatures, mask_s, mask_t,
                              tc: int = PLAIN_TC):
    """Top-2 feature-nearest target columns per source row, matrix-free:
    column blocks of -Hamming (max over variants).  Returns (cand [S, 2]
    int64, cand_ok [S, 2] bool)."""
    S = feats.words_s.shape[1]
    C = feats.words_t.shape[0]
    dev = feats.words_s.device
    fs = unpack_words(feats.words_s)
    state = _top2_init(S, dev)
    for off in range(0, C, tc):
        sl = slice(off, min(off + tc, C))
        v = -_ham_block(fs, feats.na, unpack_words(feats.words_t[sl]),
                        feats.nb[sl])
        v = torch.where(mask_s[:, None] & mask_t[None, sl], v, NEG)
        state = _merge_top2(state, v, off)
    v1, j1, v2, j2 = state
    cand = torch.stack([j1, j2], dim=1)
    cand_ok = torch.stack([v1 > NEG, v2 > NEG], dim=1) & mask_s[:, None]
    return cand, cand_ok
