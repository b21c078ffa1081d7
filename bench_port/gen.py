"""The benchmark's traffic generator: scan pairs with a known pose.

A frozen copy of the port's ``io/synthetic.py`` generators
(``structured_scene``, ``tls_scan``, and ``bench_pair`` /
``make_tls_scan_pair`` as :func:`make_pair`), so that a later change to
the program cannot change the yardstick.  Plain NumPy (and SciPy's convex
hull); imports nothing of the program.

A configuration's ``scene`` block names the pair's kind and its
parameters; a traffic file names the scene seeds of the distinct pairs a
run's pool holds.  The run's ``--seed`` draws the order in which a
closed-loop client sends them, so the same seed gives the same inputs.
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


def _yaw(deg: float) -> np.ndarray:
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)


def _pose(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def bench_pair(seed: int, n_points: int, extent: float, yaw_deg: float,
               translation, noise: float):
    """One scene seen twice, each cloud with its own noise; the source is
    the target moved by the inverse of (yaw, translation).  With the
    defaults of the port's ``bench_pair`` (800,000 points, 25 m, 20 deg,
    (2, -1.5, 0.3) m, 6 mm) it draws the same numbers.  Returns
    (source, target, T_gt), T_gt mapping source to target."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent)
    R = _yaw(yaw_deg)
    t = np.asarray(translation, np.float32)
    src = ((pts - t) @ R
           + rng.normal(0, noise, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, noise, pts.shape)).astype(np.float32)
    return src, tgt, _pose(R, t)


def tls_scan_pair(seed: int, n_points: int, extent: float, yaw_deg: float,
                  translation, noise: float, origin_a, origin_b,
                  keep_target: float, asymmetric_walls: bool):
    """Two simulated scans of one scene from two scanner origins (range
    falloff, per-origin shadowing, independent noise), rigidly offset:
    the port's ``make_tls_scan_pair``.  Returns (source, target, T_gt)."""
    rng = np.random.default_rng(seed)
    pts = structured_scene(rng, n_points, extent=extent,
                           asymmetric_walls=asymmetric_walls)
    scan_a = tls_scan(pts, origin_a, rng, keep_target=keep_target)
    scan_b = tls_scan(pts, origin_b, rng, keep_target=keep_target)
    R = _yaw(yaw_deg)
    t = np.asarray(translation, np.float32)
    src = ((scan_a - t) @ R
           + rng.normal(0, noise, scan_a.shape)).astype(np.float32)
    tgt = (scan_b + rng.normal(0, noise, scan_b.shape)).astype(np.float32)
    return src, tgt, _pose(R, t)


KINDS = {"bench_pair": bench_pair, "tls_scan_pair": tls_scan_pair}


def make_pair(scene: dict, seed: int):
    """(source, target, T_gt) of the configuration's ``scene`` block for
    one scene seed."""
    params = {k: v for k, v in scene.items() if k != "kind"}
    return KINDS[scene["kind"]](seed, **params)


def make_pool(scene: dict, scene_seeds) -> list:
    """The traffic's distinct pairs: a list of (scene seed, source,
    target, T_gt)."""
    return [(s, *make_pair(scene, s)) for s in scene_seeds]


def visits(n_pool: int, seed: int):
    """Endless pool indices for a closed-loop client: cycles that each
    visit every pair once, each cycle in an order drawn from the run's
    seed (any whole number), so every seed sends the same work in another
    order."""
    rng = np.random.default_rng(abs(int(seed)))
    while True:
        yield from (int(i) for i in rng.permutation(n_pool))
