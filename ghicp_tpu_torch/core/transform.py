"""Rigid transform utilities on float32 [4, 4] tensors.

Composition order follows the reference's ``Rt = Rt_temp * Rt``
accumulation.  Float32 matrix products on the card run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` stays False).
"""
from __future__ import annotations

import math

import torch


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a [4, 4] transform from a [3, 3] rotation and [3] shift."""
    T = torch.zeros((4, 4), dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t.reshape(3)
    T[3, 3] = 1.0
    return T


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[:3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[:3, 3]


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to [..., 3] points."""
    return torch.matmul(pts, T[:3, :3].T) + T[:3, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A after B: returns A @ B."""
    return torch.matmul(A, B)


def euler_deg_zyx(R: torch.Tensor) -> torch.Tensor:
    """Euler angles (degrees) with the reference's extraction convention:
    ax = atan2(R21, R22); ay = atan2(-R20, sqrt(R21^2 + R22^2));
    az = atan2(R01, R00)."""
    ax = torch.atan2(R[2, 1], R[2, 2])
    ay = torch.atan2(-R[2, 0], torch.sqrt(R[2, 1] ** 2 + R[2, 2] ** 2))
    az = torch.atan2(R[0, 1], R[0, 0])
    return torch.stack([ax, ay, az]) * (180.0 / math.pi)


def rotz(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``theta`` radians."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                        torch.stack([z, z, o])])
