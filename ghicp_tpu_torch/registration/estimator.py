"""Closed-form rigid transform estimators on weighted correspondences.

* :func:`kabsch_6dof` — weighted Kabsch/Umeyama; the rotation comes from
  ``torch.linalg.svd`` of the 3x3 cross-covariance with the det-sign
  repair that excludes reflections.  (The JAX package uses a Horn
  quaternion power iteration whose start vector can pick the wrong
  eigenvector near 180 degrees; the SVD has no such blind spot.)
* :func:`yaw_4dof` — closed-form leveled (yaw-only) estimate.

Both take padded correspondence tensors plus a weight vector, with any
leading batch axes (the batched engine's pair axis); an all-zero weight
vector returns the identity.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core import transform as tf


def _weighted_centroids(src, dst, w):
    wsum = torch.clamp(w.sum(dim=-1), min=1e-12)
    cs = (src * w[..., None]).sum(dim=-2) / wsum[..., None]
    cd = (dst * w[..., None]).sum(dim=-2) / wsum[..., None]
    return cs, cd, wsum


def _or_identity(T, wsum):
    """``T`` where the weights carry mass, the identity elsewhere."""
    return torch.where(wsum[..., None, None] > 1e-9, T,
                       tf.identity(T.device))


def rotation_svd(H: torch.Tensor) -> torch.Tensor:
    """Proper rotations maximizing tr(R H) for [..., 3, 3] cross-covariances
    H = sum w (s - cs)(d - cd)^T, i.e. the R with d ~ R s."""
    U, _, Vh = torch.linalg.svd(H.to(torch.float64))
    V = Vh.mT
    d = torch.sign(torch.linalg.det(V @ U.mT))
    d = torch.where(d == 0, torch.ones_like(d), d)
    one = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([one, one, d], dim=-1))
    return (V @ D @ U.mT).to(torch.float32)


def kabsch_6dof(src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The rigid T minimizing sum_i w_i |T(s_i) - d_i|^2 ([..., 4, 4]
    float32 for [..., N, 3] points and [..., N] weights)."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w)
    sc = (src - cs[..., None, :]) * w[..., None]
    H = sc.mT @ (dst - cd[..., None, :])
    R = rotation_svd(H)
    t = cd - (R @ cs[..., None])[..., 0]
    return _or_identity(tf.from_rt(R, t), wsum)


def yaw_4dof(src: torch.Tensor, dst: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Closed-form leveled (yaw-only) rigid estimate."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w)
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    num = (w * (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0])).sum(dim=-1)
    den = (w * (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1])).sum(dim=-1)
    R = tf.rotz(torch.atan2(num, den)).to(torch.float32)
    t = cd - (R @ cs[..., None])[..., 0]
    return _or_identity(tf.from_rt(R, t), wsum)


def estimate(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
             dof: int = 6) -> torch.Tensor:
    """Dispatch on degrees of freedom (4 = yaw-only, 6 = full)."""
    if dof == 4:
        return yaw_4dof(src, dst, weights)
    return kabsch_6dof(src, dst, weights)
