"""Fused cost -> benefit sweep (kernel K1), CUDA C++ in ``csrc/cost.cu``,
with its plain version.

Replaces the TPU kernel ``ghicp_tpu/ops/cost_kernel.py::fused_benefit``
(Pallas ``_kernel``).  In one pass over the [S, C] stripe it computes

  ED = scale * sqrt(|s|^2 + |t|^2 - 2 s.t)            (norm expansion)
  CD = W_ED * ED + W_FD * FD                           (additive BSC blend)
     or ED * exp(-k * log(max(FD, 1e-6)))              (``mult_blend``: the
        FPFH/RoPS lane, FD a similarity, k passed as W_FD, W_ED unused)
  b  = -CD at valid pairs, -3e38 elsewhere             (written in the
                                                        FD's type)

and, from the float32 benefits, the warm-start hints v1 = rowmax(b - p)
and vsel = (b - p)[acol0], plus the statistics count, sum CD, sum CD^2 and
max CD (only ``with_stats``), max ED and max(-CD) over valid pairs.

The FD is bf16 or, on the ``auction_bf16=False`` lane, float32.

Bound on this card: memory — one FD read and one b write, 268 MB at
8192^2 in bf16 (80 us at 3.35 TB/s), twice that in float32.  The kernel
walks bands of 64 rows with K3's sweep-0 machinery (``csrc/sweep.cuh``:
target factors staged by cp.async in double-buffered chunks, 16-byte FD
reads and b writes, the bf16 mult form's FD factor from a table in shared
memory), folds its statistics in the launch and rounds every operation as
the plain version does, so b, v1, vsel, the count and the maxima are
bit-equal to it (the sums differ by their order).  The target's factor
rows and the kernel's scratch are a :class:`CostTarget`, made once an
engine run.  The float32 variants count their launches as
``fused_benefit_f32`` and ``fused_benefit_mult_f32``.
"""
from __future__ import annotations

import struct
from typing import Optional

import torch

from ghicp_tpu_torch.matching.cost import cross3, sq_norm3
from ghicp_tpu_torch.ops import as_rows, count_launch, require_device

NEG = -3.0e38


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return struct.unpack("<f", struct.pack("<f", float(x)))[0]


def orderable(x: float) -> int:
    """The kernels' orderable key of float32 ``x`` (csrc/top2.cuh f2o), as
    a signed 32-bit int."""
    u = struct.unpack("<I", struct.pack("<f", x))[0]
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return u - (1 << 32) if u & 0x80000000 else u


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
        # the exact count, rounded once (the kernel counts in integers)
        cnt = m.sum().to(torch.float32)
        s1, s2 = cdm.sum(), (cdm * cd).sum()
        cdmax = torch.clamp(cdm.amax(), min=0.0)
    else:
        cnt = s1 = s2 = cdmax = zero
    edmax = torch.clamp(torch.where(m, ed, 0.0).amax(), min=0.0)
    bmax = torch.clamp(torch.where(m, -cd, NEG).amax(), min=NEG)
    return (bf.to(fd.dtype), cnt, s1, s2, cdmax, edmax, bmax, v1, vsel)


def target_factors(kp_t, mask_t) -> torch.Tensor:
    """[5, C] float32 rows x, y, z, |t|^2 (the kernels' order) and the
    target mask as 0 / 1: the column factors K1 and K3 stage."""
    return torch.cat([_factors(kp_t).t(),
                      mask_t[None].to(torch.float32)]).contiguous()


def _identity(t) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype, t._version)


class CostTarget:
    """What every K1 launch against one target reads unchanged, made once
    an engine run (``registration/ghicp.py::make_body``): the column
    factors ``kt`` [5, C] (:func:`target_factors`) and, on the card, the
    kernel's scratch (its statistics' accumulators, which each launch
    leaves as it found them).  It keeps the identity (address, shape, type
    and version) of ``kp_t`` and ``mask_t`` and refuses others."""

    def __init__(self, kp_t, mask_t):
        C = kp_t.shape[0]
        dev = kp_t.device
        self.kp_t = as_rows(kp_t, C, 3, torch.float32, dev, "kp_t")
        self.mask_t = as_rows(mask_t, C, 0, torch.bool, dev, "mask_t")
        self.ident = (_identity(kp_t), _identity(mask_t))
        self.kt = target_factors(self.kp_t, self.mask_t)
        self.scratch = None
        if dev.type == "cuda":
            z = lambda n, dt: torch.zeros((n,), dtype=dt, device=dev)
            mx = torch.tensor([orderable(0.0), orderable(0.0),
                               orderable(NEG)], dtype=torch.int32).to(dev)
            self.scratch = (z(2, torch.float64), z(1, torch.int64), mx,
                            z(1, torch.int32))
            self.ptrs = (self.kt.data_ptr(),
                         *(x.data_ptr() for x in self.scratch))

    def check(self, kp_t, mask_t) -> None:
        if (kp_t is not None and mask_t is not None
                and (_identity(kp_t), _identity(mask_t)) != self.ident):
            raise ValueError("fused_benefit: the target differs from the "
                             "one its CostTarget was made from")


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("cost")
    if not getattr(lib, "_typed", False):
        import ctypes
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_benefit.argtypes = ([vp, i, i, i] + [vp] * 5 + [i]
                                      + [f] * 3 + [i] * 2 + [vp] * 9)
        lib.fused_benefit.restype = i
        lib._typed = True
    return lib


def fused_benefit_cuda(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                       p_defl, acol0, with_stats: bool = True,
                       mult_blend: bool = False, target=None):
    """Launch K1 on the card (bf16 or float32 FD in, b out in its type)
    with ``target`` (a :class:`CostTarget` of ``kp_t`` and ``mask_t``,
    made here when None)."""
    from ghicp_tpu_torch.ops._build import check
    S, C = fd.shape
    if fd.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_benefit kernel takes a bf16 or float32 FD "
                         f"matrix, got {fd.dtype}")
    if C % 128:
        raise ValueError(f"fused_benefit kernel needs C % 128 == 0 (C={C})")
    if target is None:
        target = CostTarget(kp_t, mask_t)
    else:
        target.check(kp_t, mask_t)
    f32_mat = fd.dtype == torch.float32
    dev = fd.device
    kps = as_rows(kp_s, S, 3, torch.float32, dev, "kp_s")
    ms = as_rows(mask_s, S, 0, torch.bool, dev, "mask_s")
    p = as_rows(p_defl, C, 0, torch.float32, dev, "p_defl")
    if p.data_ptr() % 16:
        p = p.clone()
    if not (torch.is_tensor(acol0) and acol0.dtype in (torch.int32,
                                                       torch.int64)):
        acol0 = torch.as_tensor(acol0).to(torch.int64)
    acol0 = as_rows(acol0, S, 0, acol0.dtype, dev, "acol0")
    fd = fd.contiguous()
    b = torch.empty((S, C), dtype=fd.dtype, device=dev)
    v1, vsel, st = torch.empty((2 * S + 6,), dtype=torch.float32,
                               device=dev).split([S, S, 6])
    kt_p, *scratch = target.ptrs
    rc = _lib().fused_benefit(
        fd.data_ptr(), int(f32_mat), int(bool(mult_blend)),
        int(bool(with_stats)), kps.data_ptr(), kt_p, ms.data_ptr(),
        p.data_ptr(), acol0.data_ptr(), int(acol0.dtype == torch.int64),
        _f32(wed), _f32(wfd), _f32(scale), S, C, b.data_ptr(),
        v1.data_ptr(), vsel.data_ptr(), st.data_ptr(), *scratch,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "fused_benefit launch")
    name = ("fused_benefit" + ("_mult" if mult_blend else "")
            + ("_f32" if f32_mat else ""))
    count_launch(name)
    count_launch(f"{name}@{S}")
    return (b, *st.unbind(), v1, vsel)


def fused_benefit(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                  p_defl: Optional[torch.Tensor] = None,
                  acol0: Optional[torch.Tensor] = None,
                  with_stats: bool = True, mult_blend: bool = False,
                  target: Optional[CostTarget] = None):
    """One-sweep benefit matrix + CD statistics + warm-start hints.

    kp_s [S, 3], kp_t [C, 3] float32 (centred by a common offset first);
    fd [S, C] bf16 or float32; masks bool; ``p_defl`` [C] prices and
    ``acol0`` [S] previous assignment feed v1/vsel.  Returns (b [S, C] in
    the FD's type, cd_count, cd_sum, cd_sumsq, cd_max, ed_max, b_max,
    v1 [S], vsel [S]).  ``mult_blend`` takes the FPFH/RoPS cost
    ED / max(FD, 1e-6)^k with k in the ``wfd`` slot.  ``target``: the
    :class:`CostTarget` of ``kp_t`` and ``mask_t``, made once by the caller
    for all sweeps against that target (made a call when None).  CUDA
    tensors run the kernel, CPU tensors the plain version.
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
                                  mult_blend, target)
    return fused_benefit_plain(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd,
                               scale, p_defl, acol0, with_stats, mult_blend)
