"""Baseline registration algorithms (reference ``src/common_reg.cpp``).

The comparison registrars the reference ships next to GH-ICP
(common_reg.h:26-132), in plain PyTorch on the device the clouds lie on;
each of the JAX package's ``lax.while_loop`` / ``fori_loop`` is a host
loop here:

* :func:`icp_point2point`: classic ICP, optionally reciprocal or trimmed
  with the min-overlap gate (common_reg.cpp:44-107);
* :func:`icp_point2plane`: point-to-plane ICP on PCA target normals
  (common_reg.cpp:122-199);
* :func:`gicp`: Generalized (plane-to-plane) ICP (common_reg.cpp:216-284);
* :func:`overlap_ratio`: the radius-search overlap estimate
  (common_reg.cpp:294-317);
* :func:`sac_ia_fpfh`: FPFH + RANSAC coarse alignment
  (common_reg.cpp:392-423), every hypothesis scored in batches;
* :func:`ndt_reg`: 3D Normal-Distributions-Transform refinement, the
  working counterpart of the reference's disabled ``Reg_3DNDT``
  (src/ghicp_reg.cpp:1561-1653): voxel-Gaussian target cells and damped
  Newton steps with autograd's gradient and Hessian.

Nearest neighbors come from :func:`_nn_1` on a :class:`HashGrid`: up to
8 points of each of the 27 cells around a point, the first 8 in the
grid's stable order, the first minimum of the distances winning.  It is
not an exact nearest neighbor where a cell holds more than 8 points, and
it is kept so: another neighbor gives another pose.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.fpfh import (fpfh_features,
                                           fpfh_similarity_matrix)
from ghicp_tpu_torch.ops.eigh3 import eigh3
from ghicp_tpu_torch.preprocess.hashing import IMAX
from ghicp_tpu_torch.preprocess.neighbors import (HashGrid, _point_hash,
                                                  build_grid, offset_hashes,
                                                  radius_neighbors)
from ghicp_tpu_torch.preprocess.pca import (EIGH_BATCH,
                                            neighborhood_covariance,
                                            pca_from_neighbors)
from ghicp_tpu_torch.registration.estimator import kabsch_6dof

NN_CAP = 8          # candidates a neighbor cell (the JAX package's cap)
NN_CHUNK = 65536    # query rows a pass (bounds the [rows, 216] temporaries)


class ICPResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    iterations: int
    rmse: torch.Tensor        # final inlier RMSE
    n_inliers: int
    ok: bool = True           # False where the min-overlap gate refused
                              # (common_reg.cpp:67-70)


class NDTResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    score: torch.Tensor       # final NDT likelihood (sum of cell Gaussians)
    iterations: int           # max_iterations, as the JAX package reports


def _nn_candidates(grid: HashGrid, pts: torch.Tensor):
    """(cand [N, 27 * NN_CAP] support indices, in_cell [N, 27 * NN_CAP]):
    the first NN_CAP grid slots of each of the 27 cells around each
    point, cell by cell."""
    m = grid.sorted_keys.shape[0]
    hashes = offset_hashes(_point_hash(pts, grid.min_xyz, grid.cell))
    start = torch.searchsorted(grid.sorted_keys, hashes, side="left")
    end = torch.searchsorted(grid.sorted_keys, hashes, side="right")
    lane = torch.arange(NN_CAP, device=pts.device).repeat(27)[None, :]
    slot = start.repeat_interleave(NN_CAP, dim=1) + lane
    in_cell = slot < end.repeat_interleave(NN_CAP, dim=1)
    return grid.order[torch.clamp(slot, 0, m - 1)], in_cell


def _nn_1(grid: HashGrid, pts: torch.Tensor, mask: torch.Tensor,
          radius: float):
    """Nearest support neighbor within ``radius`` among the candidates:
    (idx [N], dist [N], ok [N])."""
    outs = []
    r2 = radius * radius
    for s in range(0, pts.shape[0], NN_CHUNK):
        p = pts[s:s + NN_CHUNK]
        cand, in_cell = _nn_candidates(grid, p)
        ok = in_cell & grid.mask[cand]
        d2 = ((grid.xyz[cand] - p[:, None, :]) ** 2).sum(dim=-1)
        d2 = torch.where(ok & (d2 <= r2), d2, torch.inf)
        k = torch.argmin(d2, dim=1, keepdim=True)      # the first minimum
        outs.append((cand.gather(1, k)[:, 0], d2.gather(1, k)[:, 0]))
    best = torch.cat([o[0] for o in outs])
    bd2 = torch.cat([o[1] for o in outs])
    good = torch.isfinite(bd2) & mask
    return best, torch.sqrt(torch.where(good, bd2, 0.0)), good


def _small_step(step: torch.Tensor, t_tol: float, r_tol: float) -> bool:
    """The reference's convergence test on one step: every translation
    entry under ``t_tol`` and every Euler angle under ``r_tol`` degrees."""
    ang = tf.euler_deg_zyx(tf.rotation(step))
    return bool((tf.translation(step).abs() < t_tol).all()
                & (ang.abs() < r_tol).all())


def _matched_rmse(new_pts, q, w):
    n = torch.clamp(w.sum(), min=1.0)
    return torch.sqrt((w * ((new_pts - q) ** 2).sum(dim=-1)).sum() / n)


def icp_point2point(source: PointCloud, target: PointCloud,
                    corr_dist: float = 1.0, max_iterations: int = 50,
                    reciprocal: bool = False, converge_t: float = 1e-4,
                    converge_r: float = 1e-3, use_trimmed: bool = False,
                    min_overlap: float = 0.0) -> ICPResult:
    """Classic point-to-point ICP (common_reg.cpp:44-107).

    ``reciprocal``: target j's nearest current source point must be the
    row (common_reg.cpp:62-66).  ``use_trimmed``: the overlap ratio is
    estimated once with a ``corr_dist`` search (``calOverlap``), each
    iteration keeps that closest fraction of the correspondences, and a
    ratio under ``min_overlap`` refuses the registration (``ok=False``,
    identity, 0 iterations; common_reg.cpp:63-75)."""
    tgrid = build_grid(target, cell=corr_dist)
    dev = source.xyz.device
    n_rows = source.capacity
    rows = torch.arange(n_rows, device=dev)
    overlap = torch.ones((), device=dev)
    refused = False
    if use_trimmed:
        _, _, ov_ok = _nn_1(tgrid, source.xyz, source.mask, corr_dist)
        n_src = torch.clamp(source.mask.to(torch.float32).sum(), min=1.0)
        overlap = ov_ok.to(torch.float32).sum() / n_src
        refused = bool(overlap < min_overlap)
    pts, rt = source.xyz, tf.identity(dev)
    it, done = 0, False
    rmse = torch.tensor(torch.inf, device=dev)
    w = torch.zeros(n_rows, device=dev)
    while not done and it < max_iterations and not refused:
        j, d, ok = _nn_1(tgrid, pts, source.mask, corr_dist)
        if reciprocal:
            sgrid = build_grid(PointCloud(xyz=pts, mask=source.mask),
                               cell=corr_dist)
            back, _, bok = _nn_1(sgrid, target.xyz[j], ok, corr_dist)
            ok = ok & bok & (back == rows)
        if use_trimmed:
            keep_n = torch.clamp(
                (overlap * ok.sum().to(torch.float32)).to(torch.int64),
                1, n_rows)
            d_sorted = torch.sort(torch.where(ok, d, torch.inf)).values
            ok = ok & (d <= d_sorted[keep_n - 1])
        w = ok.to(torch.float32)
        q = target.xyz[j]
        step = kabsch_6dof(pts, q, w)
        pts = tf.apply(step, pts)
        rmse = _matched_rmse(pts, q, w)
        rt = tf.compose(step, rt)
        it += 1
        done = _small_step(step, converge_t, converge_r)
    return ICPResult(transform=rt, iterations=it, rmse=rmse,
                     n_inliers=int(w.sum()), ok=not refused)


def _skew_step(x: torch.Tensor) -> torch.Tensor:
    """The rotation of a small-angle twist ``x`` ([rx, ry, rz]):
    I + [x]_x re-orthogonalized through its SVD."""
    z = torch.zeros((), dtype=x.dtype, device=x.device)
    K = torch.stack([torch.stack([z, -x[2], x[1]]),
                     torch.stack([x[2], z, -x[0]]),
                     torch.stack([-x[1], x[0], z])])
    U, _, Vh = torch.linalg.svd(torch.eye(3, device=x.device) + K)
    return U @ Vh


def _solve6(A: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """Weighted least squares for the twist [rx ry rz tx ty tz]."""
    AtA = A.T @ (A * w[:, None])
    Atb = A.T @ (r * w)
    x = torch.linalg.solve(AtA + 1e-8 * torch.eye(6, device=A.device), Atb)
    R = _skew_step(x[:3])
    R = R * torch.sign(torch.linalg.det(R))
    return tf.from_rt(R, x[3:])


def icp_point2plane(source: PointCloud, target: PointCloud,
                    corr_dist: float = 1.0, max_iterations: int = 30,
                    normal_radius: float = 0.5,
                    normal_k: int = 32) -> ICPResult:
    """Point-to-plane ICP with PCA target normals (common_reg.cpp:122-199):
    one linearized 6x6 solve an iteration."""
    nb = radius_neighbors(target, target, radius=normal_radius, k=normal_k)
    normals = pca_from_neighbors(target, nb).normal
    tgrid = build_grid(target, cell=corr_dist)
    dev = source.xyz.device
    pts, rt = source.xyz, tf.identity(dev)
    it, done = 0, False
    rmse = torch.tensor(torch.inf, device=dev)
    w = torch.zeros(source.capacity, device=dev)
    while not done and it < max_iterations:
        j, _, ok = _nn_1(tgrid, pts, source.mask, corr_dist)
        q, n = target.xyz[j], normals[j]
        w = ok.to(torch.float32)
        r = ((q - pts) * n).sum(dim=-1)
        A = torch.cat([torch.linalg.cross(pts, n, dim=-1), n], dim=1)
        step = _solve6(A, r, w)
        pts = tf.apply(step, pts)
        rmse = _matched_rmse(pts, q, w)
        rt = tf.compose(step, rt)
        it += 1
        done = _small_step(step, 1e-4, 1e-3)
    return ICPResult(transform=rt, iterations=it, rmse=rmse,
                     n_inliers=int(w.sum()))


def _regularized_covs(cloud: PointCloud, radius: float, k: int,
                      epsilon: float = 1e-3):
    """GICP per-point covariances: eigenvalues replaced by (1, 1, eps);
    isotropic where a neighborhood has fewer than 3 points."""
    nb = radius_neighbors(cloud, cloud, radius=radius, k=k)
    cov, _, cnt = neighborhood_covariance(cloud.xyz, nb)
    _, vecs = eigh3(cov)
    d = torch.tensor([1.0, 1.0, epsilon], device=cov.device)
    C = torch.einsum("nij,j,nkj->nik", vecs, d, vecs)
    eye = torch.eye(3, device=cov.device)
    return torch.where((cnt >= 3)[:, None, None], C, eye), cnt


def _batched_inv(M: torch.Tensor) -> torch.Tensor:
    # batches split as preprocess/pca.py splits its solver calls
    return torch.cat([torch.linalg.inv(m) for m in torch.split(M, EIGH_BATCH)])


def gicp(source: PointCloud, target: PointCloud, corr_dist: float = 1.0,
         max_iterations: int = 30, cov_radius: float = 0.5,
         cov_k: int = 24) -> ICPResult:
    """Generalized (plane-to-plane) ICP (common_reg.cpp:216-284):
    Mahalanobis-weighted Gauss-Newton on regularized covariances."""
    Cs, _ = _regularized_covs(source, cov_radius, cov_k)
    Ct, _ = _regularized_covs(target, cov_radius, cov_k)
    tgrid = build_grid(target, cell=corr_dist)
    dev = source.xyz.device
    eye3 = torch.eye(3, device=dev)
    pts, rt = source.xyz, tf.identity(dev)
    it, done = 0, False
    rmse = torch.tensor(torch.inf, device=dev)
    w = torch.zeros(source.capacity, device=dev)
    while not done and it < max_iterations:
        j, _, ok = _nn_1(tgrid, pts, source.mask, corr_dist)
        q = target.xyz[j]
        R = tf.rotation(rt)
        Csr = torch.einsum("ij,njk,lk->nil", R, Cs, R)
        M = _batched_inv(Ct[j] + Csr + 1e-6 * eye3)
        w = ok.to(torch.float32)
        r = q - pts
        z = torch.zeros_like(pts[:, 0])
        Px = torch.stack([
            torch.stack([z, pts[:, 2], -pts[:, 1]], 1),
            torch.stack([-pts[:, 2], z, pts[:, 0]], 1),
            torch.stack([pts[:, 1], -pts[:, 0], z], 1)], dim=1)
        J = torch.cat([Px, eye3.expand(Px.shape)], dim=2)       # [N, 3, 6]
        MJ = torch.einsum("nij,njk->nik", M, J)
        H = torch.einsum("nji,njk,n->ik", J, MJ, w)
        g = torch.einsum("nji,njk,nk,n->i", J, M, r, w)
        xi = torch.linalg.solve(H + 1e-6 * torch.eye(6, device=dev), g)
        Rs = _skew_step(xi[:3])
        step = tf.from_rt(Rs, xi[3:])
        pts = tf.apply(step, pts)
        rmse = _matched_rmse(pts, q, w)
        rt = tf.compose(step, rt)
        it += 1
        done = bool((xi[3:].abs() < 1e-4).all()
                    & (tf.euler_deg_zyx(Rs).abs() < 1e-3).all())
    return ICPResult(transform=rt, iterations=it, rmse=rmse,
                     n_inliers=int(w.sum()))


def overlap_ratio(cloud1: PointCloud, cloud2: PointCloud,
                  thresh: float) -> torch.Tensor:
    """Fraction of cloud1's points with a cloud2 neighbor within
    ``thresh`` (common_reg.cpp:294-317)."""
    grid = build_grid(cloud2, cell=thresh)
    _, _, ok = _nn_1(grid, cloud1.xyz, cloud1.mask, thresh)
    n = torch.clamp(cloud1.mask.to(torch.float32).sum(), min=1.0)
    return ok.to(torch.float32).sum() / n


SAC_HYP_CHUNK = 64      # hypotheses scored a pass
SAC_COL_CHUNK = 8192    # target points a pass


def _sac_scores(Ts, eval_pts, eval_mask, tgt_xyz, tgt_mask,
                inlier_thresh: float) -> torch.Tensor:
    """[H] evaluation points within ``inlier_thresh`` of a valid target
    point under each hypothesis.  The squared distances are expanded,
    |m|^2 + min_t (|t|^2 - 2 m.t), one float32 product a pass (the JAX
    package sums the squared differences: a count can differ where a
    point lies within float32 rounding of the threshold)."""
    t2 = torch.where(tgt_mask, (tgt_xyz * tgt_xyz).sum(dim=-1), torch.inf)
    n_eval = eval_pts.shape[0]
    scores = []
    for h in range(0, Ts.shape[0], SAC_HYP_CHUNK):
        moved = tf.apply(Ts[h:h + SAC_HYP_CHUNK], eval_pts).reshape(-1, 3)
        m2 = (moved * moved).sum(dim=-1)
        best = torch.full_like(m2, torch.inf)
        for c in range(0, tgt_xyz.shape[0], SAC_COL_CHUNK):
            part = torch.addmm(t2[None, c:c + SAC_COL_CHUNK], moved,
                               tgt_xyz[c:c + SAC_COL_CHUNK].T, alpha=-2.0)
            best = torch.minimum(best, part.amin(dim=1))
        inl = (m2 + best < inlier_thresh ** 2).reshape(-1, n_eval)
        scores.append((eval_mask * inl).sum(dim=1))
    return torch.cat(scores)


def sac_ia_fpfh(source: PointCloud, target: PointCloud, config,
                n_hypotheses: int = 512, n_candidates: int = 8,
                inlier_thresh: float = 0.5, n_eval: int = 512,
                seed: int = 0):
    """FPFH-guided RANSAC coarse alignment (common_reg.cpp:392-423):
    FPFH on both clouds, each source point's ``n_candidates`` most similar
    target points as candidates, then ``n_hypotheses`` 3-point rigid
    hypotheses (rows drawn without replacement among the valid ones, a
    candidate each; a ``torch.Generator`` seeded by ``seed`` on the
    device) scored on a strided subset of ``n_eval`` source points.
    Returns (T [4, 4], inlier count)."""
    dev = source.xyz.device
    radius = getattr(config, "fpfh_radius", 0.0) or \
        3.0 * getattr(config, "voxel_size", 0.1)
    hs, _ = fpfh_features(source, radius, k=24)
    ht, _ = fpfh_features(target, radius, k=24)
    sim = fpfh_similarity_matrix(hs, ht)
    sim = torch.where(source.mask[:, None] & target.mask[None, :], sim, -1.0)
    cand = torch.topk(sim, n_candidates, dim=1).indices          # [S, C]
    del sim
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = source.mask.to(torch.float32).expand(n_hypotheses, -1)
    rows = torch.multinomial(w, 3, replacement=False, generator=g)
    picks = torch.randint(0, n_candidates, (n_hypotheses, 3), generator=g,
                          device=dev)
    j = cand[rows, picks]
    Ts = kabsch_6dof(source.xyz[rows], target.xyz[j],
                     torch.ones((n_hypotheses, 3), device=dev))
    stride = max(source.capacity // n_eval, 1)
    eval_pts = source.xyz[::stride][:n_eval]
    eval_mask = source.mask[::stride][:n_eval].to(torch.float32)
    scores = _sac_scores(Ts, eval_pts, eval_mask, target.xyz, target.mask,
                         inlier_thresh)
    best = torch.argmax(scores)
    return Ts[best], scores[best]


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: the rotation of an axis-angle vector [3], Taylor-guarded
    at 0 (the Newton step linearizes there, where w / |w| has no
    derivative)."""
    th2 = (w * w).sum()
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    z = torch.zeros_like(th2)
    K = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    return torch.eye(3, device=w.device) + A * K + B * (K @ K)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1e-20)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


class _NDTCells(NamedTuple):
    hashes: torch.Tensor   # [M] ascending int32 cell hashes, IMAX padding
    mean: torch.Tensor     # [M, 3] cell means (relative to origin)
    icov: torch.Tensor     # [M, 3, 3] inverse ridge-regularized covariances
    ok: torch.Tensor       # [M] cells with at least min_cell_points
    origin: torch.Tensor   # [3] grid origin


def _ndt_cells(target: PointCloud, cell: float, max_cells: int,
               min_cell_points: int) -> _NDTCells:
    """The target's Gaussian cells: one stable sort by cell hash, then
    moment sums a cell."""
    txyz, tmask = target.xyz, target.mask
    mn = torch.where(tmask[:, None], txyz, 3e38).amin(dim=0) - cell
    keys = torch.where(tmask, _point_hash(txyz, mn, cell), IMAX)
    sk, order = torch.sort(keys, stable=True)
    heads = torch.ones_like(sk, dtype=torch.bool)
    heads[1:] = sk[1:] != sk[:-1]
    cell_id = torch.cumsum(heads.to(torch.int64), 0) - 1
    cid = torch.where((sk != IMAX) & (cell_id < max_cells), cell_id,
                      max_cells)
    xyz_s = txyz[order] - mn[None, :]      # origin-relative float32 moments
    dev = txyz.device
    cnt = torch.zeros(max_cells + 1, device=dev).index_add_(
        0, cid, torch.ones_like(xyz_s[:, 0]))
    sx = torch.zeros((max_cells + 1, 3), device=dev).index_add_(0, cid, xyz_s)
    sxx = torch.zeros((max_cells + 1, 3, 3), device=dev).index_add_(
        0, cid, xyz_s[:, :, None] * xyz_s[:, None, :])
    cnt_c = torch.clamp(cnt[:max_cells], min=1.0)
    mean = sx[:max_cells] / cnt_c[:, None]
    cov = (sxx[:max_cells] / cnt_c[:, None, None]
           - mean[:, :, None] * mean[:, None, :])
    # a ridge at (cell / 20)^2 keeps planar cells well-conditioned (PCL
    # inflates their degenerate eigenvalues to the same end)
    cov = cov + (cell / 20.0) ** 2 * torch.eye(3, device=dev)
    hashes = torch.full((max_cells + 1,), IMAX, dtype=torch.int32,
                        device=dev)
    hashes[torch.where(heads & (cid < max_cells), cid, max_cells)] = sk
    return _NDTCells(hashes=hashes[:max_cells], mean=mean, icov=_inv3(cov),
                     ok=cnt[:max_cells] >= float(min_cell_points),
                     origin=mn)


def _ndt_score(cells: _NDTCells, T: torch.Tensor, sxyz: torch.Tensor,
               smask: torch.Tensor, cell: float) -> torch.Tensor:
    """NDT likelihood of the source under ``T``: sum over points in a
    valid cell of exp(-0.5 q), q = d^T Sigma^-1 d capped at 50."""
    mn = cells.origin
    pts = tf.apply(T, sxyz) - mn[None, :]
    nh = _point_hash((pts + mn[None, :]).detach(), mn, cell)
    m = cells.hashes.shape[0]
    pos = torch.clamp(torch.searchsorted(cells.hashes, nh), max=m - 1)
    ok = (cells.hashes[pos] == nh) & cells.ok[pos] & smask
    d = pts - cells.mean[pos]
    q = torch.einsum("ni,nij,nj->n", d, cells.icov[pos], d)
    return torch.where(ok, torch.exp(-0.5 * torch.clamp(q, max=50.0)),
                       0.0).sum()


def ndt_reg(source: PointCloud, target: PointCloud, cell: float = 1.0,
            max_iterations: int = 30,
            init_transform: Optional[torch.Tensor] = None,
            max_cells: int = 65536, min_cell_points: int = 5) -> NDTResult:
    """3D NDT registration (the reference's disabled ``Reg_3DNDT``
    comparator, src/ghicp_reg.cpp:1561-1653): the target voxelized into
    ``cell``-sized Gaussian cells, the source scored under the NDT
    likelihood, the pose (translation and axis-angle, relinearized each
    step) moved by damped Newton steps on autograd's float32 gradient and
    6x6 Hessian, a step kept only where it raises the score.  A local
    refiner like ICP: start it near the pose."""
    dev = source.xyz.device
    cells = _ndt_cells(target, cell, max_cells, min_cell_points)
    sxyz, smask = source.xyz, source.mask
    T = (tf.identity(dev) if init_transform is None
         else torch.as_tensor(init_transform, dtype=torch.float32,
                              device=dev))

    def neg_score(T_):
        return -_ndt_score(cells, T_, sxyz, smask, cell)

    def loss_inc(dp, T_):
        Td = tf.from_rt(_exp_so3(dp[3:]), dp[:3])
        return neg_score(tf.compose(Td, T_))

    zero = torch.zeros(6, device=dev)
    lam = torch.tensor(1e-2, device=dev)
    best = neg_score(T)
    for _ in range(max_iterations):
        f = lambda dp: loss_inc(dp, T)
        H = torch.autograd.functional.hessian(f, zero)
        g = torch.autograd.functional.jacobian(f, zero)
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H).abs(),
                                              min=1e-6))
        dp = torch.clamp(-torch.linalg.solve(Hd, g), -0.5 * cell, 0.5 * cell)
        T_new = tf.compose(tf.from_rt(_exp_so3(dp[3:]), dp[:3]), T)
        new = neg_score(T_new)
        better = new < best
        T = torch.where(better, T_new, T)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-4),
                          torch.clamp(lam * 4.0, max=1e4))
        best = torch.where(better, new, best)
    return NDTResult(transform=T, score=-best, iterations=max_iterations)
