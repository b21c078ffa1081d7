"""Fused cost -> benefit sweep (kernel K1), Triton, with its plain version.

Replaces the TPU kernel ``ghicp_tpu/ops/cost_kernel.py::fused_benefit``
(Pallas ``_kernel``).  In one pass over the [S, C] stripe it computes

  ED = scale * sqrt(|s|^2 + |t|^2 - 2 s.t)            (norm expansion)
  CD = W_ED * ED + W_FD * FD                           (additive BSC blend)
     or ED * exp(-k * log(max(FD, 1e-6)))              (``mult_blend``: the
        FPFH/RoPS lane, FD a similarity, k passed as W_FD, W_ED unused)
  b  = -CD at valid pairs, -3e38 elsewhere             (written bf16)

and, from the float32 benefits, the warm-start hints v1 = rowmax(b - p)
and vsel = (b - p)[acol0], plus the statistics count, sum CD, sum CD^2 and
max CD (only ``with_stats``), max ED and max(-CD) over valid pairs.

Bound on this card: memory — one bf16 FD read and one bf16 b write, 268 MB
at 8192^2 (80 us at 3.35 TB/s); the arithmetic (~20 float ops an entry)
sits far below the float32 rate.  Design: one program per block of rows
walks the columns in blocks with running row maxima, so FD is read once
and b written once; the cross term is three float32 products (no tensor
cores: the JAX package computes it at HIGHEST precision), and floating-
point fusion is off so the result matches the plain version bit for bit.
The multiplicative blend takes libdevice's ``expf`` / ``logf`` (what
PyTorch's ``exp`` / ``log`` call on the card), not ``tl.exp`` / ``tl.log``,
which lower to the approximate ``ex2`` / ``lg2``.  Each program writes its statistics to a small [programs, 8] buffer that
the wrapper reduces.
"""
from __future__ import annotations

from typing import Optional

import torch

from ghicp_tpu_torch.matching.cost import cross3, sq_norm3
from ghicp_tpu_torch.ops import as_rows, count_launch, require_device

NEG = -3.0e38
BLOCK_S = 32
BLOCK_C = 256

_KERNEL = None


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _factors(kp: torch.Tensor) -> torch.Tensor:
    """[N, 4] float32 rows (x, y, z, |x|^2), norms in the kernels' order."""
    kp = kp.to(torch.float32)
    return torch.cat([kp, sq_norm3(kp)[:, None]], dim=1).contiguous()


def mult_cost(ed, sim, wfd):
    """The FPFH/RoPS blend ED / max(sim, 1e-6)^k as ED * exp(-k log(.)),
    the kernels' form (k = ``wfd``, a float32 tensor or float)."""
    return ed * torch.exp(-wfd * torch.log(torch.clamp(sim, min=1e-6)))


def factor_ed(ks, kt, scale):
    """ED [S, C] float32 from the (x, y, z, |x|^2) factor rows, in the
    kernels' operation order."""
    d2 = torch.clamp((ks[:, 3:4] + kt[None, :, 3]) - 2.0 * cross3(ks, kt),
                     min=0.0)
    return torch.tensor(_f32(scale), dtype=torch.float32,
                        device=ks.device) * torch.sqrt(d2)


def factor_cost(ks, kt, fd, wed, wfd, scale, mult_blend: bool = False):
    """(ED, CD) [S, C] float32 from the (x, y, z, |x|^2) factor rows and FD,
    in the kernels' operation order."""
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=fd.device)
    ed = factor_ed(ks, kt, scale)
    if mult_blend:
        return ed, mult_cost(ed, fd.to(torch.float32), f(wfd))
    return ed, f(wed) * ed + f(wfd) * fd.to(torch.float32)


def fused_benefit_plain(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                        p_defl, acol0, with_stats: bool = True,
                        mult_blend: bool = False):
    """Plain PyTorch version of K1 (same operation order as the kernel)."""
    S, C = fd.shape
    dev = fd.device
    ed, cd = factor_cost(_factors(kp_s), _factors(kp_t), fd, wed, wfd, scale,
                         mult_blend)
    m = mask_s[:, None] & mask_t[None, :]
    bf = torch.where(m, -cd, NEG)
    v = bf - p_defl[None, :]
    v1 = v.amax(dim=1)
    real0 = (acol0 >= 0) & (acol0 < C)
    vsel = torch.where(
        real0, torch.clamp(v.gather(1, torch.where(real0, acol0, 0)
                                    .long()[:, None])[:, 0], min=NEG), NEG)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if with_stats:
        cdm = torch.where(m, cd, 0.0)
        cnt = m.to(torch.float32).sum()
        s1, s2 = cdm.sum(), (cdm * cd).sum()
        cdmax = torch.clamp(cdm.amax(), min=0.0)
    else:
        cnt = s1 = s2 = cdmax = zero
    edmax = torch.clamp(torch.where(m, ed, 0.0).amax(), min=0.0)
    bmax = torch.clamp(torch.where(m, -cd, NEG).amax(), min=NEG)
    return (bf.to(torch.bfloat16), cnt, s1, s2, cdmax, edmax, bmax, v1, vsel)


def _kernel():
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    from ghicp_tpu_torch.ops._build import triton_cache
    triton_cache()
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def fused_benefit_kernel(kps_ptr, kpt_ptr, fd_ptr, ms_ptr, mt_ptr, p_ptr,
                             ac_ptr, b_ptr, v1_ptr, vsel_ptr, part_ptr,
                             S, C, wed, wfd, scale,
                             WITH_STATS: tl.constexpr, MULT: tl.constexpr,
                             BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_S + tl.arange(0, BLOCK_S)
        rmask = rows < S
        sx = tl.load(kps_ptr + rows * 4 + 0, mask=rmask, other=0.0)
        sy = tl.load(kps_ptr + rows * 4 + 1, mask=rmask, other=0.0)
        sz = tl.load(kps_ptr + rows * 4 + 2, mask=rmask, other=0.0)
        s2 = tl.load(kps_ptr + rows * 4 + 3, mask=rmask, other=0.0)
        ms = tl.load(ms_ptr + rows, mask=rmask, other=0) != 0
        ac = tl.load(ac_ptr + rows, mask=rmask, other=-1)
        v1 = tl.full([BLOCK_S], float("-inf"), tl.float32)
        vsel = tl.full([BLOCK_S], -3.0e38, tl.float32)
        cnt = tl.zeros([BLOCK_S], tl.float32)
        sum1 = tl.zeros([BLOCK_S], tl.float32)
        sum2 = tl.zeros([BLOCK_S], tl.float32)
        cdmax = tl.zeros([BLOCK_S], tl.float32)
        edmax = tl.zeros([BLOCK_S], tl.float32)
        bmax = tl.full([BLOCK_S], -3.0e38, tl.float32)
        for c0 in range(0, C, BLOCK_C):
            cols = c0 + tl.arange(0, BLOCK_C)
            cmask = cols < C
            tx = tl.load(kpt_ptr + cols * 4 + 0, mask=cmask, other=0.0)
            ty = tl.load(kpt_ptr + cols * 4 + 1, mask=cmask, other=0.0)
            tz = tl.load(kpt_ptr + cols * 4 + 2, mask=cmask, other=0.0)
            t2 = tl.load(kpt_ptr + cols * 4 + 3, mask=cmask, other=0.0)
            mt = tl.load(mt_ptr + cols, mask=cmask, other=0) != 0
            p = tl.load(p_ptr + cols, mask=cmask, other=0.0)
            off = rows[:, None].to(tl.int64) * C + cols[None, :]
            m2 = rmask[:, None] & cmask[None, :]
            fdv = tl.load(fd_ptr + off, mask=m2, other=0.0).to(tl.float32)
            d = ((sx[:, None] * tx[None, :] + sy[:, None] * ty[None, :])
                 + sz[:, None] * tz[None, :])
            d2 = tl.maximum((s2[:, None] + t2[None, :]) - 2.0 * d, 0.0)
            ed = scale * tl.sqrt_rn(d2)
            if MULT:
                cd = ed * libdevice.exp(
                    -wfd * libdevice.log(tl.maximum(fdv, 1e-6)))
            else:
                cd = wed * ed + wfd * fdv
            m = ms[:, None] & mt[None, :] & m2
            b = tl.where(m, -cd, -3.0e38)
            tl.store(b_ptr + off, b.to(tl.bfloat16), mask=m2)
            v = tl.where(cmask[None, :], b - p[None, :], float("-inf"))
            v1 = tl.maximum(v1, tl.max(v, axis=1))
            hit = cols[None, :] == ac[:, None]
            vsel = tl.maximum(vsel, tl.max(tl.where(hit, v, -3.0e38), axis=1))
            if WITH_STATS:
                cdm = tl.where(m, cd, 0.0)
                cnt += tl.sum(m.to(tl.float32), axis=1)
                sum1 += tl.sum(cdm, axis=1)
                sum2 += tl.sum(cdm * cd, axis=1)
                cdmax = tl.maximum(cdmax, tl.max(cdm, axis=1))
            edmax = tl.maximum(edmax, tl.max(tl.where(m, ed, 0.0), axis=1))
            bmax = tl.maximum(bmax, tl.max(tl.where(m, -cd, -3.0e38), axis=1))
        tl.store(v1_ptr + rows, v1, mask=rmask)
        tl.store(vsel_ptr + rows, vsel, mask=rmask)
        base = part_ptr + pid * 8
        tl.store(base + 0, tl.sum(cnt, axis=0))
        tl.store(base + 1, tl.sum(sum1, axis=0))
        tl.store(base + 2, tl.sum(sum2, axis=0))
        tl.store(base + 3, tl.max(cdmax, axis=0))
        tl.store(base + 4, tl.max(edmax, axis=0))
        tl.store(base + 5, tl.max(bmax, axis=0))

    _KERNEL = fused_benefit_kernel
    return _KERNEL


def fused_benefit_cuda(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                       p_defl, acol0, with_stats: bool = True,
                       mult_blend: bool = False):
    """Launch K1 on the card (bf16 FD in, bf16 b out)."""
    S, C = fd.shape
    if fd.dtype != torch.bfloat16:
        raise ValueError("fused_benefit kernel takes a bf16 FD matrix")
    dev = fd.device
    f32, i32 = torch.float32, torch.int32
    ks = _factors(as_rows(kp_s, S, 3, f32, dev, "kp_s"))
    kt = _factors(as_rows(kp_t, C, 3, f32, dev, "kp_t"))
    fd = fd.contiguous()
    b = torch.empty((S, C), dtype=torch.bfloat16, device=dev)
    v1 = torch.empty((S,), dtype=torch.float32, device=dev)
    vsel = torch.empty((S,), dtype=torch.float32, device=dev)
    n_prog = -(-S // BLOCK_S)
    part = torch.zeros((n_prog, 8), dtype=torch.float32, device=dev)
    kern = _kernel()
    kern[(n_prog,)](ks, kt, fd, as_rows(mask_s, S, 0, i32, dev, "mask_s"),
                    as_rows(mask_t, C, 0, i32, dev, "mask_t"),
                    as_rows(p_defl, C, 0, f32, dev, "p_defl"),
                    as_rows(acol0, S, 0, i32, dev, "acol0"), b, v1, vsel, part,
                    S, C, _f32(wed), _f32(wfd), _f32(scale),
                    WITH_STATS=bool(with_stats), MULT=bool(mult_blend),
                    BLOCK_S=BLOCK_S,
                    BLOCK_C=BLOCK_C, num_warps=8, enable_fp_fusion=False)
    count_launch("fused_benefit_mult" if mult_blend else "fused_benefit")
    tot = part.to(torch.float64).sum(dim=0).to(torch.float32)
    mx = part.amax(dim=0)
    return (b, tot[0], tot[1], tot[2], mx[3], mx[4], mx[5], v1, vsel)


def fused_benefit(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                  p_defl: Optional[torch.Tensor] = None,
                  acol0: Optional[torch.Tensor] = None,
                  with_stats: bool = True, mult_blend: bool = False):
    """One-sweep benefit matrix + CD statistics + warm-start hints.

    kp_s [S, 3], kp_t [C, 3] float32 (centred by a common offset first);
    fd [S, C]; masks bool; ``p_defl`` [C] prices and ``acol0`` [S] previous
    assignment feed v1/vsel.  Returns (b [S, C] bf16, cd_count, cd_sum,
    cd_sumsq, cd_max, ed_max, b_max, v1 [S], vsel [S]).  ``mult_blend``
    takes the FPFH/RoPS cost ED / max(FD, 1e-6)^k with k in the ``wfd``
    slot.  CUDA tensors run the Triton kernel, CPU tensors the plain
    version.
    """
    S, C = fd.shape
    dev = fd.device
    if p_defl is None:
        p_defl = torch.zeros((C,), dtype=torch.float32, device=dev)
    if acol0 is None:
        acol0 = torch.full((S,), -1, dtype=torch.int32, device=dev)
    if require_device(fd, "fused_benefit") == "cuda":
        return fused_benefit_cuda(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd,
                                  scale, p_defl, acol0, with_stats,
                                  mult_blend)
    return fused_benefit_plain(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd,
                               scale, p_defl, acol0, with_stats, mult_blend)
