"""BSC (Binary Shape Context) descriptors at keypoints.

Per keypoint, over its sqrt(3) * r ball (r = descriptor radius):

* local coordinate system (LCS) from distance-weighted PCA (weight
  sqrt(2) * r - dist) around the unweighted centroid: X = principal axis,
  Y = X x N (N = smallest axis), Z = X x Y.  Axis signs are canonicalized
  (largest-|component| positive), so the eigensolver's sign choice does not
  reach the descriptor;
* the neighborhood, rotated into the LCS, is projected onto the XY/XZ/YZ
  planes and binned on a g x g grid by Gaussian-weighted count and mean
  depth (weight exp(-d^2 / (2 delta^2)), delta = cell / 2, support 1.5
  cells around each cell centre);
* 441 bits (g = 7): 3 g^2 occupancy bits (normalized density > 0.1), then
  per plane g^2 random cell pairs x {depth, density} difference bits
  against mean +- one standard deviation over the pairs; the density gate
  reads plane 0 for every plane, as the reference encoder does;
* 1, 2 or 4 flipped-LCS variants as exact index permutations of the grids.

Bits are packed 32 to a word (held in int64) for storage and parity
checks; the Hamming stage works on the unpacked {0, 1} rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.ops.eigh3 import eigh3
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors

KP_CHUNK = 1024     # keypoints per grid-accumulation batch


class BSCFeatures(NamedTuple):
    packed: torch.Tensor            # [V, S, n_words] int64 (32 bits a word)
    mask: torch.Tensor              # [S] keypoint validity
    n_bits: int
    frames: Optional[torch.Tensor] = None   # [S, 3, 3] LCS rows = axes


def sample_pattern(seed: int, grid_side: int) -> np.ndarray:
    """[g^2, 2] random distinct, unordered-unique cell index pairs (a seeded
    stand-in for the reference's ``sample_pattern.txt``)."""
    g2 = grid_side * grid_side
    rng = np.random.default_rng(seed)
    pairs = []
    seen = set()
    while len(pairs) < g2:
        a, b = int(rng.integers(g2)), int(rng.integers(g2))
        if a == b or (a, b) in seen or (b, a) in seen:
            continue
        seen.add((a, b))
        pairs.append((a, b))
    return np.asarray(pairs, dtype=np.int64)


def _flip_permutations(g: int) -> np.ndarray:
    """[4, g*g]: identity, flip-both, flip-v, flip-u of a plane grid with
    cell index k = u + v * g."""
    k = np.arange(g * g)
    u, v = k % g, k // g
    return np.stack([k, (g - 1 - u) + (g - 1 - v) * g,
                     u + (g - 1 - v) * g, (g - 1 - u) + v * g])


def variant_permutations(g: int, num_variants: int) -> np.ndarray:
    """[V, 3, g^2] per-plane grid permutations of the four proper sign
    classes of the PCA axes: (x, y, z), (-x, -y, z), (x, -y, -z),
    (-x, y, -z)."""
    ident, both, flip_v, flip_u = _flip_permutations(g)
    table = [(ident, ident, ident), (both, flip_u, flip_u),
             (flip_v, flip_v, both), (flip_u, both, flip_v)]
    return np.stack([np.stack(t) for t in table])[:num_variants]


def local_frames(nxyz, nvalid, kp, r: float) -> torch.Tensor:
    """Weighted-PCA LCS per keypoint: [S, 3, 3] whose rows are the axes.
    nxyz [S, K, 3] neighbor coordinates, nvalid [S, K], kp [S, 3]."""
    dist = torch.sqrt(((nxyz - kp[:, None, :]) ** 2).sum(dim=-1))
    w = torch.where(nvalid, math.sqrt(2.0) * r - dist, 0.0)
    nv = torch.clamp(nvalid.to(torch.float32).sum(dim=1), min=1.0)
    center = torch.where(nvalid[..., None], nxyz, 0.0).sum(dim=1) / nv[:, None]
    d = torch.where(nvalid[..., None], nxyz - center[:, None, :], 0.0)
    wsum = w.sum(dim=1)
    cov = torch.einsum("sk,ski,skj->sij", w, d, d) / torch.where(
        torch.abs(wsum) > 1e-12, wsum, 1.0)[:, None, None]
    _, vecs = eigh3(cov)

    def canon(v):
        i = torch.argmax(torch.abs(v), dim=1, keepdim=True)
        return v * torch.sign(v.gather(1, i) + 1e-30)

    x = canon(vecs[:, :, 0])
    n = canon(vecs[:, :, 2])
    y = torch.linalg.cross(x, n)
    y = y / torch.clamp(torch.linalg.norm(y, dim=1, keepdim=True), min=1e-12)
    z = torch.linalg.cross(x, y)
    return torch.stack([x, y, z], dim=1)


def _grid_accumulate(local, nvalid, g: int, r: float):
    """Gaussian binning of LCS-local points [S, K, 3] onto the three planes.
    Returns (normalized density [S, 3, g^2], mean depth [S, 3, g^2])."""
    unit = 2.0 * r / g
    delta = unit * 0.5
    centers = ((torch.arange(g, dtype=torch.float32, device=local.device)
                + 0.5) * unit - r)
    support2 = (1.5 * unit) ** 2
    inv2d2 = 1.0 / (2.0 * delta * delta)
    vmask = nvalid[:, :, None, None]
    dens, depths = [], []
    for ua, va, da in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
        u, v, dep = local[..., ua], local[..., va], local[..., da] + r
        du2 = (u[..., None] - centers) ** 2                 # [S, K, g]
        dv2 = (v[..., None] - centers) ** 2
        d2 = du2[..., :, None] + dv2[..., None, :]          # [S, K, gu, gv]
        wgt = torch.where((d2 <= support2) & vmask, torch.exp(-d2 * inv2d2),
                          0.0)
        pnum = wgt.sum(dim=1)                               # [S, gu, gv]
        dsum = (wgt * dep[:, :, None, None]).sum(dim=1)
        avg = torch.where(pnum > 0, dsum / torch.clamp(pnum, min=1e-30), 0.0)
        # cell index k = u + v * g: transpose to [gv, gu] before flattening
        dens.append(pnum.transpose(1, 2).reshape(-1, g * g))
        depths.append(avg.transpose(1, 2).reshape(-1, g * g))
    pnum3 = torch.stack(dens, dim=1)
    depth3 = torch.stack(depths, dim=1)
    n_pts = torch.clamp(nvalid.to(torch.float32).sum(dim=1), min=1.0)
    neigh_density = n_pts / (math.pi * r * r)
    nw = (pnum3 / (unit * unit)) / neigh_density[:, None, None]
    return nw, depth3


def _binarize(nw, depth, pairs, thresh: float = 0.1) -> torch.Tensor:
    """Bits [..., 441] (bool) from grids [..., 3, g^2]."""
    occupancy = (nw > thresh).flatten(-2)
    p1, p2 = pairs[:, 0], pairs[:, 1]
    gate0 = (nw[..., 0, p1] < thresh) & (nw[..., 0, p2] < thresh)
    compare = []
    for plane in range(3):
        dd = depth[..., plane, p1] - depth[..., plane, p2]
        dm = dd.mean(dim=-1, keepdim=True)
        ds = torch.sqrt(((dd - dm) ** 2).mean(dim=-1, keepdim=True))
        depth_bit = torch.abs(dd - dm) > ds
        nd = nw[..., plane, p1] - nw[..., plane, p2]
        nm = nd.mean(dim=-1, keepdim=True)
        ns = torch.sqrt(((nd - nm) ** 2).mean(dim=-1, keepdim=True))
        dens_bit = ~gate0 & (torch.abs(nd - nm) > ns)
        compare.append(torch.stack([depth_bit, dens_bit], dim=-1).flatten(-2))
    return torch.cat([occupancy] + compare, dim=-1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] {0, 1} -> [..., ceil(n / 32)] int64 words (bit i of word w
    is element 32 w + i)."""
    n = bits.shape[-1]
    n_words = (n + 31) // 32
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, n_words * 32 - n))
    b = b.reshape(*b.shape[:-1], n_words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1)


def unpack_bits(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: float32 {0, 1} [..., n_bits]."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    b = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return b.reshape(*packed.shape[:-1], -1)[..., :n_bits].to(torch.float32)


def _neighborhoods(cloud: PointCloud, kp_xyz, kp_mask, radius: float,
                   neighbor_k: int):
    # cell_cap k/2: the 27-cell block keeps ~3x the K cap inside the ball,
    # so the nearest-K selection, not the cell thinning, picks neighbors
    nb = radius_neighbors(PointCloud(xyz=kp_xyz, mask=kp_mask), cloud,
                          radius=math.sqrt(3.0) * radius, k=neighbor_k,
                          cell_cap=max(neighbor_k // 2, 16))
    return cloud.xyz[nb.idx], nb.valid


def bsc_frames(cloud: PointCloud, kp_xyz: torch.Tensor,
               kp_mask: torch.Tensor, radius: float,
               neighbor_k: int = 128) -> torch.Tensor:
    """The keypoints' local frames [S, 3, 3] (rows = axes) over their
    ``neighbor_k`` nearest neighbors in the sqrt(3) * ``radius`` ball: the
    frames :func:`extract_bsc` rotates each neighborhood into (its
    ``frames``), for pose hypotheses from one correspondence."""
    nxyz, nvalid = _neighborhoods(cloud, kp_xyz, kp_mask, radius,
                                  neighbor_k)
    return local_frames(nxyz, nvalid, kp_xyz, radius)


def extract_bsc(cloud: PointCloud, keypoints: torch.Tensor, kp_mask,
                config: GHICPConfig, num_variants: int) -> BSCFeatures:
    """BSC features at keypoint locations over the support ``cloud``.

    ``keypoints``: [S] indices into the cloud or [S, 3] positions.
    ``num_variants``: 1 for the target, ``config.bsc_num_variants`` for the
    source.
    """
    kp_xyz = cloud.xyz[keypoints] if keypoints.ndim == 1 else keypoints
    dev = kp_xyz.device
    g = config.bsc_grid_side
    radius = float(config.bsc_radius or config.non_max_radius)
    pairs = torch.as_tensor(sample_pattern(config.bsc_seed, g), device=dev)
    perms = torch.as_tensor(variant_permutations(g, num_variants),
                            device=dev)                      # [V, 3, g2]
    nxyz, nvalid = _neighborhoods(cloud, kp_xyz, kp_mask, radius,
                                  config.bsc_neighbor_k)
    frames = local_frames(nxyz, nvalid, kp_xyz, radius)
    S = kp_xyz.shape[0]
    words = []
    for s in range(0, S, KP_CHUNK):
        sl = slice(s, s + KP_CHUNK)
        nv = nvalid[sl]
        local = torch.where(
            nv[..., None],
            torch.einsum("ski,sji->skj", nxyz[sl] - kp_xyz[sl, None, :],
                         frames[sl]), 2.0 * radius)
        nw, depth = _grid_accumulate(local, nv, g, radius)
        # variants: [s, V, 3, g2] index permutations of the grids
        idx = perms[None].expand(nw.shape[0], -1, -1, -1)
        V = idx.shape[1]
        nw_v = torch.gather(nw[:, None].expand(-1, V, -1, -1), 3, idx)
        dep_v = torch.gather(depth[:, None].expand(-1, V, -1, -1), 3, idx)
        bits = _binarize(nw_v, dep_v, pairs)                 # [s, V, n]
        bits = bits & kp_mask[sl, None, None]
        words.append(pack_bits(bits))
    packed = torch.cat(words).transpose(0, 1).contiguous()   # [V, S, W]
    return BSCFeatures(packed=packed, mask=kp_mask,
                       n_bits=config.bsc_total_bits, frames=frames)
