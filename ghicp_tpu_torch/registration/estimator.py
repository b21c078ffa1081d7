"""Closed-form rigid transform estimators on weighted correspondences.

* :func:`kabsch_6dof` — weighted Kabsch/Umeyama; the rotation comes from
  ``torch.linalg.svd`` of the 3x3 cross-covariance with the det-sign
  repair that excludes reflections.  (The JAX package uses a Horn
  quaternion power iteration whose start vector can pick the wrong
  eigenvector near 180 degrees; the SVD has no such blind spot.)
* :func:`yaw_4dof` — closed-form leveled (yaw-only) estimate.

Both take padded correspondence tensors plus a weight vector; an all-zero
weight vector returns the identity.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core import transform as tf


def _weighted_centroids(src, dst, w):
    wsum = torch.clamp(w.sum(), min=1e-12)
    cs = (src * w[:, None]).sum(dim=0) / wsum
    cd = (dst * w[:, None]).sum(dim=0) / wsum
    return cs, cd, wsum


def rotation_svd(H: torch.Tensor) -> torch.Tensor:
    """Proper rotation maximizing tr(R H) for a 3x3 cross-covariance
    H = sum w (s - cs)(d - cd)^T, i.e. the R with d ~ R s."""
    U, _, Vh = torch.linalg.svd(H.to(torch.float64))
    V = Vh.T
    d = torch.sign(torch.linalg.det(V @ U.T))
    d = torch.where(d == 0, torch.ones_like(d), d)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return (V @ D @ U.T).to(torch.float32)


def kabsch_6dof(src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The rigid T minimizing sum_i w_i |T(s_i) - d_i|^2 ([4, 4] float32)."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w)
    sc = (src - cs) * w[:, None]
    H = sc.T @ (dst - cd)
    R = rotation_svd(H)
    t = cd - R @ cs
    T = tf.from_rt(R, t)
    return torch.where(wsum > 1e-9, T, tf.identity(src.device))


def yaw_4dof(src: torch.Tensor, dst: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Closed-form leveled (yaw-only) rigid estimate."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w)
    s = src - cs
    d = dst - cd
    num = (w * (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0])).sum()
    den = (w * (s[:, 0] * d[:, 0] + s[:, 1] * d[:, 1])).sum()
    R = tf.rotz(torch.atan2(num, den)).to(torch.float32)
    t = cd - R @ cs
    T = tf.from_rt(R, t)
    return torch.where(wsum > 1e-9, T, tf.identity(src.device))


def estimate(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
             dof: int = 6) -> torch.Tensor:
    """Dispatch on degrees of freedom (4 = yaw-only, 6 = full)."""
    if dof == 4:
        return yaw_4dof(src, dst, weights)
    return kabsch_6dof(src, dst, weights)
