"""The plain reference that decides ``correct``.

Plain NumPy and SciPy, independent of the program: it imports nothing of
``ghicp_tpu_torch``, of the JAX package or of JAX, and takes nothing the
program made.  From the raw clouds and the true pose that the generator
made, it works out what each registration must satisfy under the
configuration's guarantees, and judges the program's outputs against it:

* the pose: rotation and translation error against the true pose, held
  to the configuration's stated limits;
* the downsample: the number of occupied voxels, counted here from the raw
  cloud (one point per voxel, the voxel of ``floor((p - min) / voxel)`` in
  float32), against the program's downsampled counts: exact;
* the keypoints: each returned keypoint lies within the refinement radius
  (3 voxels) of a point of the downsampled cloud (the lowest-index point
  of its voxel), since the refined position is a weighted mean of points
  within that radius of a downsampled point: exact, a count of those that
  do not;
* the final matching: one-to-one, every matched target index in range:
  exact, a count of the rows that break it;
* the keypoints' spacing (``kp_close``): the share of the keypoints whose
  nearest other keypoint of the same cloud lies closer than a quarter of
  the NMS radius, where suppression within that radius leaves none but
  those the refinement (a weighted mean within 3 voxels) draws together;
* the final matching against the true pose (``match_true``): the matched
  rows whose target keypoint lies within ``TRUE_VOXELS`` voxels of where
  the true pose carries the source keypoint, as a share of the source
  keypoints that have such a target keypoint.

``match_true`` is a floor (a pair fails below its limit); ``kp_close``
and ``match_true`` have limits set per cell from readings of the program
and of its faults (``bench_port/limits/``).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

# float32 rounding of a refined keypoint (a weighted mean of float32
# points) at scene coordinates up to ~60 m: far under a millimetre
KP_SLACK = 1e-4
# the distance, in voxels, within which a target keypoint stands for where
# the true pose carries a source keypoint
TRUE_VOXELS = 2.0
# the share of the NMS radius under which two keypoints count as close
CLOSE_SHARE = 0.25


def voxel_first(points: np.ndarray, voxel: float) -> np.ndarray:
    """The lowest-index point of each occupied voxel, the voxel's integer
    cell taken as floor((p - min) * float32(1 / voxel)) in float32."""
    p = np.asarray(points, np.float32)
    inv = np.float32(1.0 / voxel)
    ijk = np.floor((p - p.min(axis=0)) * inv).astype(np.int64)
    key = (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]
    _, first = np.unique(key, return_index=True)
    return p[np.sort(first)]


def rotation_error_deg(T: np.ndarray, T_gt: np.ndarray) -> float:
    """The angle of the rotation between the two poses, from the chord
    |R - R_gt|_F = 2 sqrt(2) sin(angle / 2), which keeps its digits at
    small angles (an arccos of the trace does not)."""
    d = np.linalg.norm(np.asarray(T, np.float64)[:3, :3]
                       - np.asarray(T_gt, np.float64)[:3, :3])
    return float(np.degrees(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)),
                                                1.0))))


def translation_error_m(T: np.ndarray, T_gt: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(T, np.float64)[:3, 3]
                                - np.asarray(T_gt, np.float64)[:3, 3]))


def broken_matches(matches: np.ndarray, n_target: int) -> int:
    """Matched rows that break a one-to-one matching into the target's
    ``n_target`` keypoints: an index out of range, or a target index
    already taken by another row."""
    m = np.asarray(matches, np.int64)
    m = m[m >= 0]
    bad = int((m >= n_target).sum())
    m = m[m < n_target]
    return bad + int(len(m) - len(np.unique(m)))


class PairReference:
    """What one generated pair's registrations must satisfy."""

    def __init__(self, src: np.ndarray, tgt: np.ndarray, T_gt: np.ndarray,
                 voxel: float):
        self.T_gt = np.asarray(T_gt, np.float64)
        self.voxel = float(voxel)
        self.radius = 3.0 * voxel + KP_SLACK
        self.down = [voxel_first(src, voxel), voxel_first(tgt, voxel)]
        self.trees = [cKDTree(d) for d in self.down]

    def off_cloud(self, side: int, keypoints: np.ndarray) -> int:
        """Keypoints farther than the refinement radius from every point
        of the downsampled cloud ``side`` (0 source, 1 target)."""
        kp = np.asarray(keypoints, np.float64).reshape(-1, 3)
        if len(kp) == 0:
            return 0
        d, _ = self.trees[side].query(kp, k=1,
                                      distance_upper_bound=self.radius)
        return int(np.isinf(d).sum())

    def match_true(self, out: dict, true_voxels: float = TRUE_VOXELS
                   ) -> float:
        """``match_true`` of one registration: the true pose carries each
        source keypoint into the target's frame; a target keypoint within
        ``true_voxels`` voxels of it is its true partner."""
        kp_s = np.asarray(out["keypoints_source"], np.float64).reshape(-1, 3)
        kp_t = np.asarray(out["keypoints_target"], np.float64).reshape(-1, 3)
        if len(kp_s) == 0 or len(kp_t) == 0:
            return 0.0
        tol = true_voxels * self.voxel
        moved = kp_s @ self.T_gt[:3, :3].T + self.T_gt[:3, 3]
        d, _ = cKDTree(kp_t).query(moved, k=1, distance_upper_bound=tol)
        partnered = int((~np.isinf(d)).sum())
        m = np.asarray(out["matches"], np.int64)[:len(kp_s)]
        ok = (m >= 0) & (m < len(kp_t))
        gap = np.full(len(kp_s), np.inf)
        gap[ok] = np.linalg.norm(moved[ok] - kp_t[m[ok]], axis=1)
        return int((gap < tol).sum()) / max(partnered, 1)

    def judge(self, out: dict, nms_radius: float) -> dict:
        """The numbers compared for one registration ``out`` (the
        program's outputs as host arrays: ``transform``, ``matches``,
        ``keypoints_source``, ``keypoints_target``, ``n_down``) at the
        NMS radius ``nms_radius``."""
        n_down = [len(d) for d in self.down]
        return {
            "rot_deg": rotation_error_deg(out["transform"], self.T_gt),
            "t_m": translation_error_m(out["transform"], self.T_gt),
            "down_gap": sum(abs(int(a) - b)
                            for a, b in zip(out["n_down"], n_down)),
            "kp_off": (self.off_cloud(0, out["keypoints_source"])
                       + self.off_cloud(1, out["keypoints_target"])),
            "match_broken": broken_matches(out["matches"],
                                           len(out["keypoints_target"])),
            "kp_close": close_share(
                [out["keypoints_source"], out["keypoints_target"]],
                CLOSE_SHARE * nms_radius),
            "match_true": self.match_true(out),
        }


def close_share(clouds, dist: float) -> float:
    """The share of the points of ``clouds`` (a list of [n, 3] arrays)
    whose nearest other point of the same cloud lies closer than
    ``dist``."""
    close = total = 0
    for kp in clouds:
        kp = np.asarray(kp, np.float64).reshape(-1, 3)
        total += len(kp)
        if len(kp) > 1:
            d, _ = cKDTree(kp).query(kp, k=2)
            close += int((d[:, 1] < dist).sum())
    return close / max(total, 1)


# numbers that fail below their limit; every other fails above it
FLOORS = ("match_true",)
# numbers whose limits the cell's readings set
CELL_SET = ("kp_close", "match_true")


def limits(config_limits: dict, cell_limits: dict) -> dict:
    """Every compared number's limit: the pose limits the configuration
    states, tightened where the cell's readings set lower ones; 0 for the
    exact comparisons; the cell's limits for the numbers it sets."""
    out = {"rot_deg": float(config_limits["rot_deg"]),
           "t_m": float(config_limits["t_m"]),
           "down_gap": 0, "kp_off": 0, "match_broken": 0}
    for n in ("rot_deg", "t_m"):
        if n in cell_limits:
            out[n] = min(out[n], float(cell_limits[n]))
    for n in CELL_SET:
        out[n] = float(cell_limits[n])
    return out


def breaks(name: str, value: float, limit: float) -> bool:
    """Whether ``value`` of the number ``name`` breaks ``limit``."""
    return value < limit if name in FLOORS else value > limit


def worse(name: str, a: float, b: float) -> float:
    """The worse of two readings of the number ``name``."""
    return min(a, b) if name in FLOORS else max(a, b)
