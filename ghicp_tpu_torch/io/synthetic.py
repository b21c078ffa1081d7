"""Synthetic point-cloud pair generation for tests and benchmarks.

The reference validates only on real TLS scans (README.md:75,93); our test
strategy (SURVEY.md §4) instead needs deterministic synthetic pairs with a
known ground-truth rigid transform, partial overlap, and noise.
"""
from __future__ import annotations

import numpy as np


def structured_scene(rng: np.random.Generator, n_points: int,
                     extent: float = 20.0,
                     asymmetric_walls: bool = False) -> np.ndarray:
    """A TLS-like scene: ground plane + walls + scattered distinct objects.

    Surfaces (not uniform volume noise) so that curvature keypoints and BSC
    features are meaningful, mimicking the terrestrial scans the reference
    targets (README.md:16-20).  The object mix is deliberately diverse
    (yawed boxes, slant-roofed boxes, cylinders, octahedra) so that
    curvature keypoints are *point-like and repeatable* across independent
    samplings — long featureless edges produce NMS keypoints at arbitrary
    positions and no registration pipeline can match them.

    ``asymmetric_walls``: give the two walls distinct heights and relief
    statistics.  At high wall-point densities the default (congruent)
    walls admit a ~90-degree wall-swap near-symmetry that can win RANSAC
    consensus over the true pose (NOTES round 4 — a generator artifact;
    real facades carry symmetry-breaking relief).  Off by default so the
    long-standing benchmark scenes stay bit-identical.
    """
    parts = []
    n_ground = n_points // 6
    g = rng.uniform([-extent, -extent, 0], [extent, extent, 0.02],
                    size=(n_ground, 3))
    parts.append(g)

    n_wall = n_points // 6
    # Walls carry protruding boxes (windows/pilasters): long straight
    # wall-ground / wall-top creases otherwise yield thousands of identical
    # edge keypoints (the curvature detector keeps 1D-edge eigenprofiles,
    # keypoint_detect.hpp:132-147) whose BSC descriptors form one giant
    # impostor cluster — measured to be the dominant failure mode of
    # feature matching on this synthetic.  Real TLS facades get their
    # distinctiveness from exactly this kind of varied relief.
    n_flat = n_wall // 2
    h1, h2 = (6.0, 3.5) if asymmetric_walls else (6.0, 6.0)
    w1 = rng.uniform([-extent, -extent, 0], [extent, -extent + 0.02, h1],
                     size=(n_flat // 2, 3))
    w2 = rng.uniform([-extent, -extent, 0], [-extent + 0.02, extent, h2],
                     size=(n_flat - n_flat // 2, 3))
    parts.extend([w1, w2])
    n_prot = n_wall - n_flat
    n_per_prot = max(n_prot // 50, 6)
    placed_p = 0
    while placed_p < n_prot:
        m = min(n_per_prot, n_prot - placed_p)
        if asymmetric_walls:
            # Distinct relief statistics per wall (see docstring): wall 1
            # gets dense small window-scale protrusions over its full
            # height band, wall 2 sparse large pilasters near the ground.
            on_w1 = rng.random() < 0.7
            sz = (rng.uniform(0.2, 0.6, size=3) if on_w1
                  else rng.uniform(0.9, 1.8, size=3))
        else:
            # Draw order below (sz, u, face, along, height, coin) must stay
            # EXACTLY the historical one: the benchmark scenes are pinned
            # by seed and any re-ordering of RNG consumption changes them.
            on_w1 = None
            sz = rng.uniform(0.25, 1.2, size=3)
        u = rng.uniform(0, 1, size=(m, 3))
        # protrusion = box sticking out of the wall plane by sz (sample the
        # 5 exposed faces via rejection: drop the wall-side face)
        face = rng.integers(0, 5, size=m)
        pts = np.zeros((m, 3))
        for k in range(m):
            f = face[k]
            p = u[k] * sz
            if f == 0:
                p[1] = sz[1]        # outer face
            elif f == 1:
                p[0] = 0.0
            elif f == 2:
                p[0] = sz[0]
            elif f == 3:
                p[2] = 0.0
            else:
                p[2] = sz[2]
            pts[k] = p
        along = rng.uniform(-extent * 0.95, extent * 0.95)
        if asymmetric_walls:
            height = rng.uniform(0.0, 5.0 if on_w1 else 2.2)
        else:
            height = rng.uniform(0.0, 5.0)
            on_w1 = rng.random() < 0.5
        if on_w1:
            base = np.array([along, -extent, height])
            parts.append(base + pts)
        else:
            base = np.array([-extent, along, height])
            parts.append(base + pts[:, [1, 0, 2]])
        placed_p += m

    n_boxes = n_points - n_ground - n_wall
    n_per_box = max(n_boxes // 40, 8)
    placed = 0
    obj_id = 0
    while placed < n_boxes:
        c = rng.uniform([-extent * 0.8, -extent * 0.8, 0],
                        [extent * 0.8, extent * 0.8, 0])
        m = min(n_per_box, n_boxes - placed)
        kind = obj_id % 4
        obj_id += 1
        if kind == 2:
            # vertical cylinder (tree trunk / pillar): distinctive curvature
            radius = rng.uniform(0.2, 1.2)
            height = rng.uniform(1.0, 6.0)
            ang = rng.uniform(0, 2 * np.pi, m)
            z = rng.uniform(0, height, m)
            pts = np.stack([radius * np.cos(ang), radius * np.sin(ang), z], 1)
            parts.append(c + pts)
        elif kind == 3:
            # random-sheared box: a yawed box pushed through a random shear,
            # so every corner has its own trihedral angle configuration
            # (clone corners of axis-aligned primitives are descriptor
            # impostors — see the bench-scene failure analysis)
            size = rng.uniform(0.8, 4.0, size=3)
            face = rng.integers(0, 6, size=m)
            uv = rng.uniform(0, 1, size=(m, 2))
            pts = np.zeros((m, 3))
            for axis in range(3):
                lo = face == 2 * axis
                hi = face == 2 * axis + 1
                others = [a for a in range(3) if a != axis]
                for sel, val in ((lo, 0.0), (hi, 1.0)):
                    pts[sel, axis] = val
                    pts[sel, others[0]] = uv[sel, 0]
                    pts[sel, others[1]] = uv[sel, 1]
            pts = pts * size
            S = np.eye(3) + rng.uniform(-0.35, 0.35, (3, 3)) * (1 - np.eye(3))
            yaw = rng.uniform(0, 2 * np.pi)
            Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                           [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
            pts = pts @ S.T @ Rz.T
            pts[:, 2] -= pts[:, 2].min()
            parts.append(c + pts)
        else:
            # random convex "crystal": the hull of 6-10 random vertices.
            # Every vertex has a unique solid-angle configuration, so local
            # descriptors (BSC) can tell objects apart — the property the
            # registration benchmark actually needs from a TLS-like scene
            # (real facades get it from varied window/cornice geometry).
            from scipy.spatial import ConvexHull, QhullError
            s = rng.uniform(0.6, 2.2)
            for _ in range(8):
                v = rng.normal(size=(int(rng.integers(6, 11)), 3))
                v = v / np.linalg.norm(v, axis=1, keepdims=True)
                v = v * (s * rng.uniform(0.5, 1.0, (len(v), 1)))
                try:
                    hull = ConvexHull(v)
                    break
                except QhullError:
                    continue
            else:
                continue
            tris = v[hull.simplices]                      # [F, 3, 3]
            ab = tris[:, 1] - tris[:, 0]
            ac = tris[:, 2] - tris[:, 0]
            area = 0.5 * np.linalg.norm(np.cross(ab, ac), axis=1)
            f = rng.choice(len(tris), m, p=area / area.sum())
            r1 = np.sqrt(rng.uniform(0, 1, m))[:, None]
            r2 = rng.uniform(0, 1, m)[:, None]
            pts = ((1 - r1) * tris[f, 0] + r1 * (1 - r2) * tris[f, 1]
                   + r1 * r2 * tris[f, 2])
            pts[:, 2] -= v[:, 2].min()
            parts.append(c + pts)
        placed += m
    scene = np.concatenate(parts, axis=0)[:n_points]
    return scene.astype(np.float32)


def make_pair(seed: int = 0, n_points: int = 20000,
              rotation_deg: float = 10.0, translation: float = 1.0,
              noise: float = 0.01, overlap: float = 0.8,
              yaw_only: bool = False, extent: float = 20.0):
    """Generate (source, target, T_gt) with T_gt mapping source -> target.

    Partial overlap is produced by slicing each cloud to an overlapping
    half-space band; both clouds get independent noise realizations.
    """
    rng = np.random.default_rng(seed)
    scene = structured_scene(rng, int(n_points / max(overlap, 0.1)), extent)

    # overlap window along x
    xs = scene[:, 0]
    lo, hi = np.quantile(xs, [0.0, 1.0])
    span = hi - lo
    cut = lo + span * (1.0 - overlap)
    target_pts = scene[xs >= lo + span * 0.0]
    source_sel = scene[xs >= cut] if overlap < 1.0 else scene
    target_sel = scene[xs <= hi - span * (1.0 - overlap)] if overlap < 1.0 else scene

    # ground-truth transform: source = T_gt^-1(target region); we instead
    # define clean source points and transform them by T_gt to sit in the
    # target frame.
    angle = np.deg2rad(rotation_deg) * rng.uniform(0.3, 1.0)
    if yaw_only:
        axis = np.array([0.0, 0.0, 1.0])
    else:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    t = rng.uniform(-translation, translation, size=3)
    if yaw_only:
        t[2] *= 0.1
    T_gt = np.eye(4, dtype=np.float64)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t

    # source cloud lives in its own frame: apply inverse of T_gt to the
    # shared geometry, so that T_gt maps source -> target.
    src_clean = (source_sel - t) @ R  # == R^T (x - t)
    source = src_clean + rng.normal(scale=noise, size=src_clean.shape)
    target = target_sel + rng.normal(scale=noise, size=target_sel.shape)
    return (source.astype(np.float32), target.astype(np.float32),
            T_gt.astype(np.float32))


def tls_scan(pts: np.ndarray, origin, rng: np.random.Generator,
             keep_target: float = 0.5, az_bins: int = 2048,
             el_bins: int = 512, shadow_slack: float = 1.06) -> np.ndarray:
    """Simulate a terrestrial-laser scan of surface points ``pts`` from a
    scanner at ``origin``: range-dependent sampling density and angular
    occlusion — the two properties of real TLS data the plain synthetic
    pairs lack (the reference's demo
    envelope is real ETH/WHU scans, README.md:14-27).

    * **density**: a scanner emits on a fixed angular grid, so surface
      sample density falls off ~1/r^2.  Points survive with probability
      (r0/r)^2 where r0 is calibrated so roughly ``keep_target`` of the
      input survives.
    * **occlusion**: per (azimuth, elevation) cell only points within
      ``shadow_slack`` of the nearest return survive — surfaces behind
      other surfaces vanish, DIFFERENTLY per scan origin.

    Two scans of the same scene from different origins therefore disagree
    in density, coverage and shadowing — the regime real pairwise TLS
    registration must survive.
    """
    o = np.asarray(origin, np.float32)
    d = pts - o[None, :]
    r = np.linalg.norm(d, axis=1) + 1e-6
    # azimuth/elevation cell per point
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2] / r, -1, 1))
    ia = np.clip(((az + np.pi) / (2 * np.pi) * az_bins).astype(np.int64),
                 0, az_bins - 1)
    ie = np.clip(((el + np.pi / 2) / np.pi * el_bins).astype(np.int64),
                 0, el_bins - 1)
    cell = ia * el_bins + ie
    # nearest return per cell (shadow map)
    near = np.full(az_bins * el_bins, np.inf, np.float32)
    np.minimum.at(near, cell, r)
    visible = r <= near[cell] * shadow_slack
    # range falloff: calibrate r0 so E[min((r0/r)^2, 1)] over the visible
    # set reaches ~keep_target
    rv = r[visible]
    r0 = float(np.percentile(rv, 5)) if len(rv) else 1.0
    for _ in range(30):
        if np.minimum((r0 / rv) ** 2, 1.0).mean() >= keep_target:
            break
        r0 *= 1.15
    keep = visible & (rng.random(len(pts)) < np.minimum((r0 / r) ** 2, 1.0))
    return pts[keep]


def make_tls_scan_pair(seed: int = 0, n_points: int = 2_000_000,
                       extent: float = 25.0, rot_deg: float = 25.0,
                       translation=(2.0, -1.5, 0.3), noise: float = 0.006,
                       origin_a=(0.0, 0.0, 1.8), origin_b=(10.0, 8.0, 1.8),
                       keep_target: float = 0.45,
                       asymmetric_walls: bool = True):
    """A registration pair of two simulated scans of one scene from two
    SCAN ORIGINS (range falloff + per-origin shadowing + independent
    noise), rigidly offset — much closer to the reference's ETH/WHU demo
    regime than shared-density noise pairs.  Returns (src, tgt, T_gt).

    Scan pairs default to the de-symmetrized scene: at high densities the
    congruent-wall scene's ~90-degree wall-swap mode can beat the true
    pose in RANSAC consensus (a generator artifact, NOTES round 4)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent,
                           asymmetric_walls=asymmetric_walls)
    scan_a = tls_scan(pts, origin_a, rng, keep_target=keep_target)
    scan_b = tls_scan(pts, origin_b, rng, keep_target=keep_target)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.asarray(translation, np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((scan_a - t) @ R
           + rng.normal(0, noise, scan_a.shape)).astype(np.float32)
    tgt = (scan_b + rng.normal(0, noise, scan_b.shape)).astype(np.float32)
    return src, tgt, T_gt


def bench_pair(n_points: int = 800_000, extent: float = 25.0, seed: int = 7):
    """The TLS-scale benchmark pair: one scene, independent 6 mm noise on
    each cloud, a 20-degree yaw and a (2, -1.5, 0.3) m shift.  Returns
    (source, target, T_gt)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent)
    theta = np.deg2rad(20.0)
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    t = np.float32([2.0, -1.5, 0.3])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R
           + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def stream_pair(n_points: int = 2_000_000, extent: float = 40.0,
                seed: int = 29):
    """The dense-scan pair of the streaming lane (the JAX package's
    ``bench_configs.py`` config 6): one 40 m scene, independent 6 mm noise
    on each cloud, a 12-degree yaw and a (1.5, -1.0, 0.2) m shift.  Returns
    (source, target, T_gt)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent)
    theta = np.deg2rad(12.0)
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    t = np.float32([1.5, -1.0, 0.2])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    src = ((pts - t) @ R
           + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    return src, tgt, T_gt


def registration_problem(S: int, T: int, seed: int = 0,
                         rot_deg: float = 5.0, n_bits: int = 441,
                         flip: float = 0.06):
    """Keypoint-scale engine problem with a known rigid offset and
    correlated binary features: target bits random, each of two source
    variants copies its true partner's bits with ``flip`` noise, so the
    min-Hamming FD is low on true pairs.  Returns (src [S, 3], tgt [T, 3],
    fd [S, T], bits_s [2, S, n_bits], bits_t [1, T, n_bits], T_gt)."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-12, 12, (T, 3)).astype(np.float32)
    th = np.deg2rad(rot_deg)
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.float32([0.5, -0.3, 0.1])
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    perm = rng.permutation(T)[:S]
    src = ((tgt[perm] - t) @ R
           + rng.normal(0, 0.01, (S, 3))).astype(np.float32)
    bits_t = (rng.random((1, T, n_bits)) < 0.35).astype(np.float32)
    noise = rng.random((2, S, n_bits)) < flip
    bits_s = np.where(noise, 1.0 - bits_t[0][perm],
                      bits_t[0][perm]).astype(np.float32)
    ham = np.zeros((2, S, T), np.float32)
    for v in range(2):
        ham[v] = (bits_s[v].sum(1)[:, None] + bits_t[0].sum(1)[None, :]
                  - 2.0 * bits_s[v] @ bits_t[0].T)
    return src, tgt, ham.min(0), bits_s, bits_t, T_gt


def station_graph(n_stations: int = 6, n_points: int = 250_000,
                  extent: float = 18.0, seed: int = 21):
    """The station graph of the JAX package's ``bench_configs.py`` config 5:
    one structured scene seen from ``n_stations`` TLS stations, station i
    at yaw 8 i degrees and shift (0.9 i, -0.6 i, 0.05 i) m, each cloud with
    its own 6 mm noise; pairs are the chain (i + 1, i) plus the loop
    closure (n - 1, 0).  Returns (clouds, poses_gt, pairs, config): pose i
    maps station i's frame into the world (station 0's), and ``config`` is
    config 5's BSC + KM setting."""
    from ghicp_tpu_torch.core.config import (CorrespondenceType,
                                             FeatureType, GHICPConfig)
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent)

    def rigid(theta_deg, t):
        th = np.deg2rad(theta_deg)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        T[:3, 3] = t
        return T.astype(np.float32)

    poses_gt = [rigid(8.0 * i, [0.9 * i, -0.6 * i, 0.05 * i])
                for i in range(n_stations)]
    clouds = []
    for P in poses_gt:
        R, t = P[:3, :3], P[:3, 3]
        local = (pts - t) @ R   # world -> station frame
        clouds.append((local + rng.normal(0, 0.006, pts.shape)
                       ).astype(np.float32))
    pairs = [(i + 1, i) for i in range(n_stations - 1)]
    pairs.append((n_stations - 1, 0))   # loop closure
    cfg = GHICPConfig(feature=FeatureType.BSC,
                      correspondence=CorrespondenceType.KM,
                      voxel_size=0.1, neighborhood_radius=0.5,
                      non_max_radius=0.5, min_neighbors=15,
                      bsc_neighbor_k=256, pca_cell_cap=40,
                      pca_max_cells=65536, keypoint_capacity=8192,
                      estimated_overlap=0.9, max_iterations=40)
    return clouds, poses_gt, pairs, cfg
