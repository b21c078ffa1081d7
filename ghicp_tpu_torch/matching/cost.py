"""Cost-matrix pieces shared by the engine: ED and the BSC blend.

* ``euclidean_matrix`` — ED[i, j] = scale * ||s_i - t_j|| by the norm
  expansion, with the cross term as explicit float32 products (no
  reduced-precision matrix unit);
* ``blend_bsc`` — CD = W_ED * ED + W_FD * FD, W_FD = exp(-iter / rate),
  with the penalty schedule of :func:`bsc_penalty`.

Masked pairs carry CD = +inf; statistics run over valid pairs only.  Both
take an optional leading pair axis ([P, S, 3] keypoints, [P, S, T]
matrices) and then compute their statistics per pair.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CostResult(NamedTuple):
    cd: torch.Tensor        # [S, T] blended cost, +inf at invalid pairs
    penalty: torch.Tensor   # scalar penalty (outlier gate)
    cd_mean: torch.Tensor
    cd_std: torch.Tensor


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., S, T] dot products of [..., S, 3] and [..., T, 3] rows, each
    product and sum rounded in float32 in a fixed order (the kernels use
    the same order, so plain and kernel results agree bit for bit)."""
    return ((a[..., 0:1] * b[..., None, :, 0]
             + a[..., 1:2] * b[..., None, :, 1])
            + a[..., 2:3] * b[..., None, :, 2])


def sq_norm3(a: torch.Tensor) -> torch.Tensor:
    """|a|^2 per row in the same fixed order as :func:`cross3`."""
    return ((a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
            + a[..., 2] * a[..., 2])


def euclidean_matrix(src: torch.Tensor, tgt: torch.Tensor,
                     scale) -> torch.Tensor:
    """ED[..., i, j] = scale * ||src_i - tgt_j|| (``scale`` a scalar, or
    [P, 1, 1] with a pair axis).  Updated in place after the cross term:
    one [..., S, T] buffer beside cross3's temporaries."""
    d2 = cross3(src, tgt).mul_(-2.0).add_(
        sq_norm3(src)[..., :, None] + sq_norm3(tgt)[..., None, :])
    return d2.clamp_(min=0.0).sqrt_().mul_(scale)


def _masked_stats(x: torch.Tensor, m: torch.Tensor):
    """Mean and std of ``x`` over mask ``m``, per matrix of the last two
    axes."""
    n = torch.clamp(m.sum(dim=(-2, -1)).to(torch.float32), min=1.0)
    xm = torch.where(m, x, 0.0)
    s1 = xm.sum(dim=(-2, -1))
    s2 = xm.mul_(xm).sum(dim=(-2, -1))
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def bsc_penalty(mean, std, iteration, rms, fdm, fdstd, para1, para2, scale,
                wed, wfd, penalty_initial: float):
    """BSC penalty schedule from CD statistics: CD-statistics driven on
    iterations 0-1, RMS/FDM/FDstd driven afterwards, floored at 5."""
    pen_late = rms * para1 * scale * wed + (fdm + para2 * fdstd) * wfd
    pen_early = mean - penalty_initial * std
    penalty = torch.where(torch.as_tensor(iteration > 1), pen_late,
                          pen_early)
    return torch.clamp(penalty, min=5.0)


def blend_bsc(ed, fd, mask_s, mask_t, iteration, rms, fdm, fdstd, para1,
              para2, scale, weight_changing_rate: float,
              penalty_initial: float) -> CostResult:
    """Hybrid BSC cost + penalty schedule.  With a pair axis,
    ``iteration`` and the state scalars are [P] tensors."""
    m = mask_s[..., :, None] & mask_t[..., None, :]
    it = torch.as_tensor(iteration, dtype=torch.float32, device=ed.device)
    wfd = torch.exp(-it / weight_changing_rate)
    wed = 1.0 - wfd
    cd = (ed * wed[..., None, None]).add_(fd * wfd[..., None, None])
    mean, std = _masked_stats(cd, m)
    penalty = bsc_penalty(mean, std, it, rms, fdm, fdstd, para1,
                          para2, scale, wed, wfd, penalty_initial)
    return CostResult(cd=cd.masked_fill_(~m, torch.inf), penalty=penalty,
                      cd_mean=mean, cd_std=std)
