"""Outlier and region filters (reference ``include/filter.hpp:91-143``).

Mask-based (no compaction), on the device the cloud lies on:

* :func:`sor_filter`: statistical outlier removal (``SORFilter``,
  filter.hpp:91-103): drop points whose mean K-NN distance exceeds
  global_mean + std_mul * global_std.
* :func:`distance_filter`: keep points inside a horizontal-distance ring
  and a z band (``DisFilter``, filter.hpp:105-117, which computes
  ``x^2 + y + y``; this is the intended ``x^2 + y^2``, SURVEY.md §2).
* :func:`bbx_filter`: drop points inside any of a set of boxes
  (``ActiveObjectFilter``, filter.hpp:119-141).
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors


def sor_filter(cloud: PointCloud, mean_k: int = 50, std_mul: float = 2.0,
               radius: float = 1.0) -> PointCloud:
    """Mask out points whose mean distance to their ``mean_k`` nearest
    neighbors (within ``radius``, the point itself excluded) lies beyond
    mean + std_mul * std of that statistic over the cloud; a point with no
    neighbor is an outlier."""
    nb = radius_neighbors(cloud, cloud, radius=radius, k=mean_k,
                          include_self=False)
    d = torch.sqrt(torch.where(nb.valid, nb.dist2, 0.0))
    n_nb = nb.valid.sum(dim=1)
    mean_d = d.sum(dim=1) / torch.clamp(n_nb, min=1)
    valid = cloud.mask & (n_nb > 0)
    n = torch.clamp(valid.sum(), min=1)
    mu = torch.where(valid, mean_d, 0.0).sum() / n
    var = torch.where(valid, (mean_d - mu) ** 2, 0.0).sum() / n
    keep = valid & (mean_d <= mu + std_mul * torch.sqrt(var))
    return PointCloud(xyz=cloud.xyz, mask=keep)


def distance_filter(cloud: PointCloud, xy_dis_max: float, z_min: float,
                    z_max: float) -> PointCloud:
    """Keep points with horizontal distance < xy_dis_max and z in the
    open band (z_min, z_max)."""
    x, y, z = cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]
    r = torch.tensor(xy_dis_max, dtype=torch.float32)    # squared in float32
    keep = (cloud.mask & (x * x + y * y < (r * r).to(x.device))
            & (z > z_min) & (z < z_max))
    return PointCloud(xyz=cloud.xyz, mask=keep)


def bbx_filter(cloud: PointCloud, bbx_min, bbx_max) -> PointCloud:
    """Drop points strictly inside any box; ``bbx_min`` / ``bbx_max``
    [B, 3] corners (ActiveObjectFilter semantics)."""
    lo = torch.as_tensor(bbx_min, dtype=torch.float32,
                         device=cloud.xyz.device)
    hi = torch.as_tensor(bbx_max, dtype=torch.float32,
                         device=cloud.xyz.device)
    p = cloud.xyz[:, None, :]
    inside = ((p > lo[None]) & (p < hi[None])).all(dim=-1)
    return PointCloud(xyz=cloud.xyz, mask=cloud.mask & ~inside.any(dim=-1))
