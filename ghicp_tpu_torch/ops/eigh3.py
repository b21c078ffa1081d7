"""Batched 3x3 symmetric eigendecomposition by cyclic Jacobi (plain
PyTorch; the JAX package's ``ops/eigh3.py``, which is not a kernel).

Six fixed sweeps of the three plane rotations over every matrix at once.
The port keeps this solver wherever the JAX package uses it (the FPFH
normals, the RoPS frame): FPFH's Darboux angles change with the sign of
each normal and no step orients the normals, so another solver's signs
(``torch.linalg.eigh``'s) would give other histograms without an error.
"""
from __future__ import annotations

import torch

_PAIRS = ((0, 1), (0, 2), (1, 2))


def _jacobi_rotation(app, aqq, apq):
    """Givens rotation (c, s) annihilating the off-diagonal ``apq``."""
    nz = torch.abs(apq) > 0
    theta = (aqq - app) / (2.0 * torch.where(nz, apq, 1.0))
    t = torch.sign(theta) / (torch.abs(theta)
                             + torch.sqrt(theta * theta + 1.0))
    t = torch.where(theta == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    return torch.where(nz, c, 1.0), torch.where(nz, s, 0.0)


def _rotate(m, p: int, q: int, c, s, dim: int):
    """Rows (``dim`` -2) or columns (-1) p, q of ``m`` rotated by (c, s)."""
    mp, mq = m.select(dim, p), m.select(dim, q)
    c, s = c[..., None], s[..., None]
    new = {p: c * mp - s * mq, q: s * mp + c * mq}
    return torch.stack([new.get(k, m.select(dim, k)) for k in range(3)],
                       dim=dim)


def eigh3(A: torch.Tensor, sweeps: int = 6):
    """(eigvals [..., 3] descending, eigvecs [..., 3, 3]) of symmetric
    [..., 3, 3] matrices; ``eigvecs[..., :, k]`` belongs to
    ``eigvals[..., k]``, with the JAX package's signs."""
    A = A.to(torch.float32)
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    A = A / scale
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for p, q in _PAIRS:
            c, s = _jacobi_rotation(A[..., p, p], A[..., q, q], A[..., p, q])
            A = _rotate(A, p, q, c, s, -2)
            A = _rotate(A, p, q, c, s, -1)
            V = _rotate(V, p, q, c, s, -1)
    vals = torch.diagonal(A, dim1=-2, dim2=-1) * scale[..., 0]
    order = torch.argsort(-vals, dim=-1, stable=True)
    vals = torch.gather(vals, -1, order)
    vecs = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return vals, vecs
