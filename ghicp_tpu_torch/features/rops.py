"""RoPS (Rotational Projection Statistics) descriptors at keypoints, and
their similarity (the JAX package's ``features/rops.py``).

Per keypoint: a fixed-K radius neighborhood; a distance-weighted scatter
about the keypoint solved by the Jacobi
:func:`~ghicp_tpu_torch.ops.eigh3.eigh3` for the local frame (x and z
turned toward the weighted majority of the offsets, y = z x x); the local
surface turned by T angles about each frame axis; after each turn, the
points projected onto the three coordinate planes, binned into an L x L
distribution and summarised by five statistics (mu11, mu21, mu12, mu22 and
the Shannon entropy).  3 * T * 3 * 5 values a keypoint (135 at T = 3).

All keypoints, turns and planes run as one batch; the L x L distributions
are counted with a ``bincount`` (the JAX package's one-hot product gives
the same integers).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.fpfh import center_norm
from ghicp_tpu_torch.ops.eigh3 import eigh3
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors

_PLANES = ((0, 1), (0, 2), (1, 2))


class RoPSFeatures(NamedTuple):
    desc: torch.Tensor   # [S, D] float32 (zero rows at masked keypoints)
    mask: torch.Tensor   # [S] bool


def _f32(x: float) -> float:
    return float(np.float32(x))


def _rops_lrf(d: torch.Tensor, valid: torch.Tensor, r: float):
    """[S, 3, 3] local frames (rows = axes) from the offsets ``d`` [S, K, 3]
    of the valid neighbors from their keypoint."""
    dist = torch.sqrt((d * d).sum(dim=-1))
    w = torch.where(valid, torch.clamp(r - dist, min=0.0), 0.0)
    cov = torch.einsum("sk,ski,skj->sij", w, d, d) / torch.clamp(
        w.sum(dim=1), min=1e-12)[:, None, None]
    _, vecs = eigh3(cov)
    x, z = vecs[..., :, 0], vecs[..., :, 2]
    sign = lambda a: torch.where(
        (w * torch.einsum("ski,si->sk", d, a)).sum(dim=1) >= 0, 1.0, -1.0)
    x = x * sign(x)[:, None]
    z = z * sign(z)[:, None]
    y = torch.linalg.cross(z, x)
    y = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True),
                        min=1e-12)
    z = torch.linalg.cross(x, y)
    return torch.stack([x, y, z], dim=-2)


def _axis_rotations(n_rotations: int) -> np.ndarray:
    """[3, T, 3, 3] rotations: T angles in [0, pi) about each frame axis."""
    thetas = np.arange(n_rotations) * (np.pi / n_rotations)
    out = np.zeros((3, n_rotations, 3, 3), np.float32)
    for a in range(3):
        for t, th in enumerate(thetas):
            c, s = np.cos(th), np.sin(th)
            m = np.eye(3, dtype=np.float32)
            i, j = [(1, 2), (0, 2), (0, 1)][a]
            m[i, i] = c
            m[j, j] = c
            m[i, j] = -s
            m[j, i] = s
            out[a, t] = m
    return out


def _plane_stats(u, v, valid, r: float, L: int):
    """[..., 5] statistics of the L x L distribution of (u, v) [..., K]
    over [-r, r]^2 (``valid`` [..., K] weights the points)."""
    # the JAX package's (x + r) / cell, which XLA on the CPU evaluates as a
    # product with the float32 reciprocal of the constant cell
    inv_cell = _f32(1.0 / _f32(2.0 * r / L))
    cell = lambda x: torch.clamp(torch.floor((x + r) * inv_cell), 0,
                                 L - 1).to(torch.int64)
    lead = u.shape[:-1]
    n = int(np.prod(lead))
    base = torch.arange(n, device=u.device).reshape(lead + (1,)) * (L * L)
    idx = (base + cell(u) * L + cell(v)).reshape(-1)
    wts = valid.to(torch.float32).expand(u.shape).reshape(-1)
    D = torch.bincount(idx, weights=wts, minlength=n * L * L).to(
        torch.float32).reshape(lead + (L, L))
    D = D / torch.clamp(D.sum(dim=(-2, -1), keepdim=True), min=1e-12)
    li = torch.arange(L, dtype=torch.float32, device=u.device)
    ibar = (li * D.sum(dim=-1)).sum(dim=-1)
    jbar = (li * D.sum(dim=-2)).sum(dim=-1)
    di = (li - ibar[..., None])[..., :, None]
    dj = (li - jbar[..., None])[..., None, :]
    tot = lambda x: x.sum(dim=(-2, -1))
    ent = -tot(torch.where(D > 0, D * torch.log(torch.clamp(D, min=1e-12)),
                           0.0))
    return torch.stack([tot(di * dj * D), tot(di * di * dj * D),
                        tot(di * dj * dj * D), tot(di * di * dj * dj * D),
                        ent], dim=-1)


def rops_features(cloud: PointCloud, keypoints: torch.Tensor,
                  kp_mask: torch.Tensor, radius: float, neighbor_k: int = 256,
                  n_rotations: int = 3, n_bins: int = 5) -> RoPSFeatures:
    """RoPS descriptors at ``keypoints`` ([S] indices into the cloud or
    [S, 3] positions) over the support ``cloud``: [S, 3 * T * 3 * 5]."""
    kp = cloud.xyz[keypoints] if keypoints.ndim == 1 else keypoints
    r = float(radius)
    nb = radius_neighbors(PointCloud(xyz=kp, mask=kp_mask), cloud, radius=r,
                          k=int(neighbor_k),
                          cell_cap=max(int(neighbor_k) // 4, 16))
    valid = nb.valid
    d = torch.where(valid[..., None], cloud.xyz[nb.idx] - kp[:, None, :],
                    0.0)                                     # [S, K, 3]
    R = _rops_lrf(d, valid, r)
    local = torch.where(valid[..., None],
                        torch.einsum("skj,sij->ski", d, R), 0.0)
    rots = torch.as_tensor(_axis_rotations(int(n_rotations)),
                           device=kp.device).reshape(-1, 3, 3)
    q = torch.einsum("skj,tij->stki", local, rots)           # [S, 3T, K, 3]
    u = torch.stack([q[..., a] for a, _ in _PLANES], dim=2)  # [S, 3T, 3, K]
    v = torch.stack([q[..., b] for _, b in _PLANES], dim=2)
    stats = _plane_stats(u, v, valid[:, None, None, :], r, int(n_bins))
    desc = stats.reshape(kp.shape[0], -1)
    return RoPSFeatures(desc=torch.where(kp_mask[:, None], desc, 0.0),
                        mask=kp_mask)


def whiten_dims(fs: torch.Tensor, ft: torch.Tensor):
    """Both descriptor sets standardized per dimension by the mean and
    std over the live rows of both (zero rows excluded)."""
    both = torch.cat([fs, ft], dim=0)
    live = (torch.abs(both).sum(dim=1) > 0).to(torch.float32)
    n = torch.clamp(live.sum(), min=1.0)
    mean = (both * live[:, None]).sum(dim=0) / n
    var = (((both - mean) ** 2) * live[:, None]).sum(dim=0) / n
    inv = 1.0 / torch.sqrt(torch.clamp(var, min=1e-12))
    return (fs - mean) * inv, (ft - mean) * inv


def rops_similarity_matrix(fs: torch.Tensor, ft: torch.Tensor):
    """[S, T] |Pearson correlation| of the per-dimension whitened
    descriptors, in [0, 1] (the FPFH similarity contract)."""
    a, b = whiten_dims(fs, ft)
    return torch.abs(torch.matmul(center_norm(a), center_norm(b).T))
