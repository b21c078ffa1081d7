"""Ground-truth evaluation harness.

Revives the reference's disabled evaluation tooling (``cal_gt_match`` /
``cal_recall_precision``, src/ghicp_reg.cpp:1113-1184 under ``#if 0``;
SURVEY.md §4): given a ground-truth transform, score correspondence quality
and final registration error.  Host numpy (a copy of the JAX package's
module): callers pass host arrays.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def gt_matches(kp_s: np.ndarray, kp_t: np.ndarray, T_gt: np.ndarray,
               max_dist: float) -> np.ndarray:
    """[S] index of the ground-truth target match per source keypoint
    (-1 if none within ``max_dist``; reference gt_maxdis = nonmax/3,
    ghicp_reg.h:93)."""
    moved = kp_s @ T_gt[:3, :3].T + T_gt[:3, 3]
    d = np.linalg.norm(moved[:, None] - kp_t[None], axis=-1)
    j = d.argmin(axis=1)
    return np.where(d[np.arange(len(kp_s)), j] <= max_dist, j, -1)


def correspondence_pr(matches: np.ndarray, weights: np.ndarray,
                      gt: np.ndarray) -> Dict[str, float]:
    """Precision/recall of a matcher's output vs ground-truth matches.

    matches/weights: the engine's [S] target index + 0/1 weight;
    gt: [S] ground-truth target index or -1.
    """
    predicted = weights > 0
    correct = predicted & (matches == gt) & (gt >= 0)
    n_pred = int(predicted.sum())
    n_gt = int((gt >= 0).sum())
    return {
        "precision": float(correct.sum()) / max(n_pred, 1),
        "recall": float(correct.sum()) / max(n_gt, 1),
        "n_predicted": n_pred,
        "n_gt": n_gt,
    }


def registration_report(T_est: np.ndarray, T_gt: np.ndarray,
                        kp_s: Optional[np.ndarray] = None,
                        kp_t: Optional[np.ndarray] = None,
                        matches: Optional[np.ndarray] = None,
                        weights: Optional[np.ndarray] = None,
                        gt_max_dist: float = 0.5) -> Dict[str, float]:
    """Full evaluation: transform error + optional correspondence P/R."""
    dR = T_est[:3, :3] @ T_gt[:3, :3].T
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    report: Dict[str, float] = {
        "rotation_error_deg": float(np.degrees(np.arccos(c))),
        "translation_error_m": float(np.linalg.norm(T_est[:3, 3]
                                                    - T_gt[:3, 3])),
    }
    if kp_s is not None and matches is not None:
        gt = gt_matches(kp_s, kp_t, T_gt, gt_max_dist)
        report.update(correspondence_pr(matches, weights, gt))
    return report
