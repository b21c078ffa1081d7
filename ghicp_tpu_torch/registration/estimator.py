"""Closed-form rigid transform estimators on weighted correspondences.

* :func:`kabsch_6dof` — weighted Kabsch/Umeyama; the rotation comes from
  ``torch.linalg.svd`` of the 3x3 cross-covariance with the det-sign
  repair that excludes reflections.  (The JAX package uses a Horn
  quaternion power iteration whose start vector can pick the wrong
  eigenvector near 180 degrees; the SVD has no such blind spot.)
* :func:`yaw_4dof` — closed-form leveled (yaw-only) estimate.
* :func:`similarity_2d_4p` / :func:`similarity_3d_7p` — the weighted
  linear least-squares similarity transforms of the reference's
  ``CSTRAN_4DOF`` / ``CSTRAN_7DOF`` (common_reg.cpp:425-617), in float32.

Both take padded correspondence tensors plus a weight vector, with any
leading batch axes (the batched engine's pair axis); an all-zero weight
vector returns the identity.  Under a distributed ``comm`` the
correspondences are this rank's rows: the weight sums, centroids, the 3x3
cross-covariance (or the yaw's two sums) are summed over the ranks before
the solve, which then runs the same on every rank.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.comm import LOCAL, Comm


def _weighted_centroids(src, dst, w, comm: Comm = LOCAL):
    wsum = torch.clamp(comm.psum(w.sum(dim=-1)), min=1e-12)
    cs = comm.psum((src * w[..., None]).sum(dim=-2)) / wsum[..., None]
    cd = comm.psum((dst * w[..., None]).sum(dim=-2)) / wsum[..., None]
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
                weights: torch.Tensor, comm: Comm = LOCAL) -> torch.Tensor:
    """The rigid T minimizing sum_i w_i |T(s_i) - d_i|^2 ([..., 4, 4]
    float32 for [..., N, 3] points and [..., N] weights)."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w, comm)
    sc = (src - cs[..., None, :]) * w[..., None]
    H = comm.psum(sc.mT @ (dst - cd[..., None, :]))
    R = rotation_svd(H)
    t = cd - (R @ cs[..., None])[..., 0]
    return _or_identity(tf.from_rt(R, t), wsum)


def yaw_4dof(src: torch.Tensor, dst: torch.Tensor,
             weights: torch.Tensor, comm: Comm = LOCAL) -> torch.Tensor:
    """Closed-form leveled (yaw-only) rigid estimate."""
    w = weights.to(torch.float32)
    cs, cd, wsum = _weighted_centroids(src, dst, w, comm)
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    num = comm.psum((w * (s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0]))
                    .sum(dim=-1))
    den = comm.psum((w * (s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1]))
                    .sum(dim=-1))
    R = tf.rotz(torch.atan2(num, den)).to(torch.float32)
    t = cd - (R @ cs[..., None])[..., 0]
    return _or_identity(tf.from_rt(R, t), wsum)


def _weighted_lls(A: torch.Tensor, b: torch.Tensor,
                  ww: torch.Tensor) -> torch.Tensor:
    """The solution of (A^T W A + 1e-9 I) x = A^T W b (float32)."""
    AtA = A.T @ (A * ww[:, None])
    Atb = A.T @ (b * ww)
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-9 * eye, Atb)


def similarity_2d_4p(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """2D 4-parameter similarity (tx, ty, scale, yaw) by weighted linear
    least squares: x' = a x - b y + tx, y' = b x + a y + ty, scale =
    hypot(a, b).  Returns [tx, ty, s, sin, cos]."""
    w = weights.to(torch.float32)
    x, y = src_xy[:, 0], src_xy[:, 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([ones, zeros, x, -y], dim=1),
                   torch.stack([zeros, ones, y, x], dim=1)])
    b = torch.cat([dst_xy[:, 0], dst_xy[:, 1]])
    tx, ty, a, bb = _weighted_lls(A, b, torch.cat([w, w]))
    s = torch.sqrt(a * a + bb * bb)
    return torch.stack([tx, ty, s, bb / s, a / s])


def similarity_3d_7p(src: torch.Tensor, dst: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Linearized (small-angle) 7-parameter 3D similarity by weighted
    linear least squares: [tx, ty, tz, rx, ry, rz, scale]."""
    w = weights.to(torch.float32)
    x, y, z = src[:, 0], src[:, 1], src[:, 2]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([ones, zeros, zeros, zeros, -z, y, x], dim=1),
                   torch.stack([zeros, ones, zeros, z, zeros, -x, y], dim=1),
                   torch.stack([zeros, zeros, ones, -y, x, zeros, z],
                               dim=1)])
    b = torch.cat([dst[:, 0], dst[:, 1], dst[:, 2]])
    return _weighted_lls(A, b, torch.cat([w, w, w]))


def estimate(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
             dof: int = 6, comm: Comm = LOCAL) -> torch.Tensor:
    """Dispatch on degrees of freedom (4 = yaw-only, 6 = full)."""
    if dof == 4:
        return yaw_4dof(src, dst, weights, comm)
    return kabsch_6dof(src, dst, weights, comm)
