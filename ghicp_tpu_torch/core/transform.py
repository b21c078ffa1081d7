"""Rigid transform utilities on float32 [..., 4, 4] tensors (any leading
batch axes, e.g. the pair axis of the batched engine).

Composition order follows the reference's ``Rt = Rt_temp * Rt``
accumulation.  Float32 matrix products on the card run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` stays False).
"""
from __future__ import annotations

import math

import torch

from ghicp_tpu_torch.core.device import resolve_device


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] transforms from [..., 3, 3] rotations and
    [..., 3] shifts."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform [4, 4] to [..., 3] points, or transforms
    [P, 4, 4] to their [P, N, 3] point sets."""
    return (torch.matmul(pts, T[..., :3, :3].transpose(-1, -2))
            + T[..., None, :3, 3])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A after B: returns A @ B."""
    return torch.matmul(A, B)


def invert(T: torch.Tensor) -> torch.Tensor:
    """The inverse of rigid transforms [..., 4, 4]: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def euler_deg_zyx(R: torch.Tensor) -> torch.Tensor:
    """Euler angles (degrees) with the reference's extraction convention:
    ax = atan2(R21, R22); ay = atan2(-R20, sqrt(R21^2 + R22^2));
    az = atan2(R01, R00)."""
    ax = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ay = torch.atan2(-R[..., 2, 0],
                     torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    az = torch.atan2(R[..., 0, 1], R[..., 0, 0])
    return torch.stack([ax, ay, az], dim=-1) * (180.0 / math.pi)


def rotz(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``theta`` radians."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def random_rigid(generator: torch.Generator, max_rotation_deg: float = 30.0,
                 max_translation: float = 1.0, yaw_only: bool = False,
                 device=None) -> torch.Tensor:
    """A random rigid transform [4, 4] for synthetic pairs, drawn from
    ``generator`` (the JAX package's distribution: a rotation about a
    normal-random axis, or about +z with ``yaw_only``, by an angle uniform
    in +-``max_rotation_deg``; each shift uniform in +-``max_translation``).
    The draws are made in float32 on the generator's device; the result
    lands on ``device`` (the card by default)."""
    dev = resolve_device(device)
    gdev = generator.device
    max_rad = max_rotation_deg * math.pi / 180.0

    def uniform(n: int, lim: float) -> torch.Tensor:
        u = torch.rand(n, generator=generator, device=gdev)
        return (2.0 * u - 1.0) * lim

    if yaw_only:
        R = rotz(uniform(1, max_rad)[0])
    else:
        axis = torch.randn(3, generator=generator, device=gdev)
        axis = axis / torch.linalg.norm(axis)
        angle = uniform(1, max_rad)[0]
        z = torch.zeros((), device=gdev)
        K = torch.stack([torch.stack([z, -axis[2], axis[1]]),
                         torch.stack([axis[2], z, -axis[0]]),
                         torch.stack([-axis[1], axis[0], z])])
        R = (torch.eye(3, device=gdev)
             + torch.sin(angle) * K + (1.0 - torch.cos(angle)) * (K @ K))
    t = uniform(3, max_translation)
    return from_rt(R, t).to(dev)
