"""The port's evaluation harness against the JAX package's: the same
numbers on the same inputs."""
import numpy as np
import pytest

from ghicp_tpu.registration import evaluate as jev
from ghicp_tpu_torch.registration import evaluate as tev


def _problem(seed):
    rng = np.random.default_rng(seed)
    kp_t = rng.uniform(0, 10, (60, 3)).astype(np.float32)
    th = np.deg2rad(5.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                 [0, 0, 1]]
    T[:3, 3] = [0.5, -0.2, 0.1]
    kp_s = ((kp_t - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    kp_s[50:] += rng.normal(0, 0.5, (10, 3)).astype(np.float32)
    matches = np.arange(60)
    matches[40:45] = 0
    w = np.ones(60)
    w[45:48] = 0
    return kp_s, kp_t, T, matches, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_numbers_as_jax(seed):
    kp_s, kp_t, T, matches, w = _problem(seed)
    for d in (0.05, 0.3):
        np.testing.assert_array_equal(tev.gt_matches(kp_s, kp_t, T, d),
                                      jev.gt_matches(kp_s, kp_t, T, d))
    gt = tev.gt_matches(kp_s, kp_t, T, 0.05)
    assert tev.correspondence_pr(matches, w, gt) == jev.correspondence_pr(
        matches, w, gt)
    T_est = T.copy()
    T_est[:3, 3] += 0.01
    for args in ((T_est, T), (T_est, T, kp_s, kp_t, matches, w, 0.05)):
        assert tev.registration_report(*args) == jev.registration_report(
            *args)


def test_perfect_matches():
    """The JAX suite's case (tests/test_evaluate.py)."""
    kp_s, kp_t, T, matches, w = _problem(0)
    gt = tev.gt_matches(kp_s[:50], kp_t[:50], T, max_dist=0.05)
    np.testing.assert_array_equal(gt, np.arange(50))
    pr = tev.correspondence_pr(matches[:50], np.r_[w[:45], np.zeros(5)], gt)
    assert abs(pr["precision"] - 40 / 45) < 1e-9
    assert abs(pr["recall"] - 40 / 50) < 1e-9
    rep = tev.registration_report(T, T, kp_s, kp_t, matches, w)
    assert rep["rotation_error_deg"] < 1e-3
    assert rep["translation_error_m"] < 1e-6
    assert "precision" in rep
