"""Core tensor types: the padded point cloud.

A cloud is a fixed-capacity ``[N, 3]`` float32 coordinate tensor plus an
``[N]`` validity mask.  Capacities come from :func:`bucket_size`, so the
shapes a run sees stay in a small set, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def round_up(n: int, multiple: int) -> int:
    """``n`` rounded up to the next multiple of ``multiple``."""
    return -(-n // multiple) * multiple


def bucket_size(n: int, multiple: int = 256, min_size: int = 256) -> int:
    """Static bucket capacity for ``n`` live elements (power-of-two steps)."""
    n = max(n, 1)
    size = max(min_size, multiple)
    while size < n:
        size *= 2
    return size


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A fixed-capacity point cloud: padded coordinates + validity mask.

    Rows at ``mask == False`` are padding, filled with the live centroid so
    that distance-based code stays numerically tame.
    """

    xyz: torch.Tensor   # [N, 3] float32
    mask: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @classmethod
    def from_points(cls, pts, capacity: Optional[int] = None,
                    device: torch.device | str = "cpu") -> "PointCloud":
        """Build a padded cloud from a host-side [n, 3] array."""
        pts = np.asarray(pts, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"expected [n,3] points, got {pts.shape}")
        n = pts.shape[0]
        cap = capacity if capacity is not None else bucket_size(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        fill = pts.mean(axis=0) if n else np.zeros(3, np.float32)
        xyz = np.full((cap, 3), fill, dtype=np.float32)
        xyz[:n] = pts
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        return cls(xyz=torch.from_numpy(xyz).to(device),
                   mask=torch.from_numpy(mask).to(device))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                keepdim: bool = False) -> torch.Tensor:
    """Mean of ``x`` over entries where ``mask`` is true."""
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / torch.clamp((m * torch.ones_like(x)).sum(),
                                           min=1.0)
    num = (x * m).sum(dim=dim, keepdim=keepdim)
    den = torch.clamp((m * torch.ones_like(x)).sum(dim=dim, keepdim=keepdim),
                      min=1.0)
    return num / den


def stable_live_first(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting ``mask`` rows first, each group in index order
    (the stable ``argsort(~mask)`` of the JAX package)."""
    return torch.sort((~mask).to(torch.int8), stable=True).indices


def compact_device(cloud: PointCloud,
                   capacity: Optional[int] = None) -> PointCloud:
    """Compact live points into a smaller bucket without leaving the
    device; padding rows are filled with the live centroid."""
    if capacity is None:
        capacity = bucket_size(int(cloud.mask.sum()))
    cap = min(capacity, cloud.capacity)
    sel = stable_live_first(cloud.mask)[:cap]
    cmask = cloud.mask[sel]
    centroid = masked_mean(cloud.xyz, cloud.mask[:, None], dim=0)
    xyz = torch.where(cmask[:, None], cloud.xyz[sel], centroid)
    return PointCloud(xyz=xyz, mask=cmask)


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Axis-aligned bounding box."""

    min_xyz: torch.Tensor  # [3]
    max_xyz: torch.Tensor  # [3]

    @property
    def magnitude(self) -> torch.Tensor:
        """Sum of extents (the reference's ``bbx_magnitude``)."""
        return torch.sum(self.max_xyz - self.min_xyz)


def cloud_bounds(cloud: PointCloud) -> Bounds:
    """Masked bounding box of a padded cloud."""
    m = cloud.mask[:, None]
    mn = torch.where(m, cloud.xyz, 3.0e38).amin(dim=0)
    mx = torch.where(m, cloud.xyz, -3.0e38).amax(dim=0)
    return Bounds(min_xyz=mn, max_xyz=mx)
