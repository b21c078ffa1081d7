"""FPFH (Fast Point Feature Histograms) over a whole cloud, and their
|Pearson| similarity (the JAX package's ``features/fpfh.py``).

1. SPFH: for every point p (normal n_p) and neighbor q, the Darboux angles
   (alpha, phi, theta) of the pair, with the rule that the point whose
   normal makes the smaller angle with the connecting line is the source,
   binned into three 11-bin histograms.
2. FPFH(p) = SPFH(p) + (1/k) sum_q SPFH(q) / |p - q|, each 11-bin block
   normalised to sum 100.

Normals come from the same neighborhoods through the Jacobi solver
(:func:`~ghicp_tpu_torch.preprocess.pca.pca_from_neighbors`), whose
eigenvector signs the angles depend on.  Histograms are counted with a
``bincount`` instead of one-hot sums (the same integers), and the
neighbor sum runs over chunks of points, so no [N, K, 33] tensor exists.
"""
from __future__ import annotations

import math

import torch

from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors
from ghicp_tpu_torch.preprocess.pca import pca_from_neighbors

N_BINS = 11  # per angle; 33 in all
CHUNK = 65536


def _pair_features(p1, n1, p2, n2, valid):
    """Darboux angles of point pairs: (alpha, phi, theta, d, ok)."""
    dp = p2 - p1
    d = torch.sqrt((dp * dp).sum(dim=-1))
    dpn = dp / torch.where(d > 0, d, 1.0)[..., None]
    a1 = (n1 * dpn).sum(dim=-1)
    a2 = (n2 * dpn).sum(dim=-1)
    swap = (torch.abs(a1) < torch.abs(a2))[..., None]
    ns = torch.where(swap, n2, n1)
    nt = torch.where(swap, n1, n2)
    dpn = torch.where(swap, -dpn, dpn)
    phi = (ns * dpn).sum(dim=-1)
    v = torch.linalg.cross(dpn, ns.expand_as(dpn))
    vn = torch.sqrt((v * v).sum(dim=-1))
    v = v / torch.clamp(vn, min=1e-12)[..., None]
    w = torch.linalg.cross(ns.expand_as(v), v)
    alpha = (v * nt).sum(dim=-1)
    theta = torch.atan2((w * nt).sum(dim=-1), (ns * nt).sum(dim=-1))
    ok = valid & (d > 0) & (vn > 1e-12)
    return alpha, phi, theta, d, ok


def _histogram(alpha, phi, theta, ok):
    """[N, K] angles -> [N, 33] counts over the valid entries."""
    def bins(f, lo, hi):
        b = ((f - lo) * (N_BINS / (hi - lo))).to(torch.int64)
        return torch.clamp(b, 0, N_BINS - 1)

    n = alpha.shape[0]
    row = torch.arange(n, device=alpha.device)[:, None] * (3 * N_BINS)
    idx = torch.cat([row + bins(alpha, -1.0, 1.0),
                     row + N_BINS + bins(phi, -1.0, 1.0),
                     row + 2 * N_BINS + bins(theta, -math.pi, math.pi)],
                    dim=1)
    w = ok.to(torch.float32).repeat(1, 3)
    return torch.bincount(idx.reshape(-1), weights=w.reshape(-1),
                          minlength=n * 3 * N_BINS).reshape(
                              n, 3 * N_BINS).to(torch.float32)


def _normalize_blocks(hist):
    """Each 11-bin block scaled to sum 100."""
    blocks = hist.reshape(*hist.shape[:-1], 3, N_BINS)
    s = blocks.sum(dim=-1, keepdim=True)
    blocks = torch.where(s > 0, blocks / torch.clamp(s, min=1e-12) * 100.0,
                         0.0)
    return blocks.reshape(hist.shape)


def fpfh_features(cloud: PointCloud, radius: float, k: int = 32):
    """([N, 33] FPFH histograms, [N] normal validity) of every cloud
    point."""
    nb = radius_neighbors(cloud, cloud, radius=radius, k=k,
                          include_self=False)
    pca = pca_from_neighbors(cloud, nb)
    normals, xyz = pca.normal, cloud.xyz
    n = xyz.shape[0]
    spfh, inv_d, oks = [], [], []
    for s in range(0, n, CHUNK):
        idx = nb.idx[s:s + CHUNK]
        alpha, phi, theta, d, ok = _pair_features(
            xyz[s:s + CHUNK, None, :], normals[s:s + CHUNK, None, :],
            xyz[idx], normals[idx], nb.valid[s:s + CHUNK])
        spfh.append(_histogram(alpha, phi, theta, ok))
        inv_d.append(torch.where(ok, 1.0 / torch.clamp(d, min=1e-6), 0.0))
        oks.append(ok)
    spfh = torch.cat(spfh)
    out = []
    for c, s in enumerate(range(0, n, CHUNK)):
        w, ok = inv_d[c], oks[c]
        cnt = torch.clamp(ok.to(torch.float32).sum(dim=1), min=1.0)
        neigh = torch.einsum("nk,nkf->nf", w, spfh[nb.idx[s:s + CHUNK]])
        out.append(_normalize_blocks(spfh[s:s + CHUNK]
                                     + neigh / cnt[:, None]))
    return torch.cat(out), pca.valid


def center_norm(x: torch.Tensor) -> torch.Tensor:
    """Rows centred and scaled to unit length (zero rows stay zero)."""
    xc = x - x.mean(dim=-1, keepdim=True)
    return xc / torch.clamp(torch.linalg.norm(xc, dim=-1, keepdim=True),
                            min=1e-12)


def fpfh_similarity_matrix(fs: torch.Tensor, ft: torch.Tensor):
    """[S, T] |Pearson correlation| of the histograms, in [0, 1]: one
    float32 product of the centred, normalised rows (full float32 on the
    card: the callers leave TF32 off)."""
    return torch.abs(torch.matmul(center_norm(fs), center_norm(ft).T))
