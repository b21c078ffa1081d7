"""Rigid estimators of the port against scipy's rotation oracle, and
against the JAX package away from 180 degrees; the similarity solvers
against the JAX package's on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ghicp_tpu.registration import estimator as jest
from ghicp_tpu.registration.estimator import estimate as jax_estimate
from ghicp_tpu_torch.registration.estimator import (estimate,
                                                    similarity_2d_4p,
                                                    similarity_3d_7p,
                                                    yaw_4dof)

torch.set_num_threads(1)

CASES = [((0.0, 0.0, 1.0), 20.0), ((1.0, 2.0, -0.5), 75.0),
         ((0.3, -1.0, 0.2), 150.0), ((1.0, 0.0, -1.0), 180.0),
         ((0.0, 1.0, 0.0), 179.5)]


def _pair(axis, deg, seed=0, n=200):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    R = Rotation.from_rotvec(np.deg2rad(deg) * np.asarray(axis)
                             / np.linalg.norm(axis)).as_matrix()
    t = np.array([1.0, -2.0, 0.5])
    dst = (src @ R.T + t + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, n).astype(np.float32)
    w[::17] = 0.0
    return src, dst, w


@pytest.mark.parametrize("axis,deg", CASES)
def test_kabsch_matches_scipy_oracle(axis, deg):
    src, dst, w = _pair(axis, deg)
    T_est = estimate(torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(w)).numpy()
    cs = (src * w[:, None]).sum(0) / w.sum()
    cd = (dst * w[:, None]).sum(0) / w.sum()
    R_ref, _ = Rotation.align_vectors(dst - cd, src - cs, weights=w)
    # entrywise: float32 rounding alone moves an arccos-of-trace angle by
    # ~0.02 degrees near the identity
    np.testing.assert_allclose(T_est[:3, :3], R_ref.as_matrix(), atol=1e-5)
    np.testing.assert_allclose(T_est[:3, 3], cd - R_ref.as_matrix() @ cs,
                               atol=1e-4)
    if deg < 179.0:
        T_j = np.asarray(jax_estimate(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(w)))
        np.testing.assert_allclose(T_est, T_j, atol=1e-4)


def test_yaw_only_and_degenerate_weights():
    src, dst, w = _pair((0.0, 0.0, 1.0), 33.0, seed=2)
    T_est = yaw_4dof(torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(w)).numpy()
    assert abs(np.degrees(np.arctan2(T_est[1, 0], T_est[0, 0])) - 33.0) < 0.05
    assert abs(T_est[2, 2] - 1.0) < 1e-6
    zero = torch.zeros(len(w))
    for dof in (4, 6):
        T0 = estimate(torch.from_numpy(src), torch.from_numpy(dst), zero,
                      dof=dof)
        assert torch.equal(T0, torch.eye(4))


def test_similarity_solvers_match_jax():
    """The weighted linear least-squares similarities (the reference's
    CSTRAN_4DOF / CSTRAN_7DOF) on tests/test_core.py's inputs: the known
    transform recovered, and the JAX package's solution within rtol 1e-4
    (a float32 solve on both sides, another summation order)."""
    rng = np.random.default_rng(7)
    src = rng.normal(size=(100, 3)).astype(np.float32) * 10
    w = rng.uniform(0.5, 1.5, 100).astype(np.float32)
    th, s = np.deg2rad(10.0), 1.3
    R2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    dst_xy = (src[:, :2] @ (s * R2).T + np.array([2.0, -1.0])).astype(
        np.float32)
    small = np.array([0.01, -0.02, 0.015])
    K = np.array([[0, -small[2], small[1]], [small[2], 0, -small[0]],
                  [-small[1], small[0], 0]])
    dst = (1.05 * (src @ (np.eye(3) + K.T))
           + np.array([1.0, 2.0, 3.0])).astype(np.float32)
    t = torch.from_numpy
    for weights in (np.ones(100, np.float32), w):
        p = similarity_2d_4p(t(src[:, :2]), t(dst_xy), t(weights)).numpy()
        pj = np.asarray(jest.similarity_2d_4p(
            jnp.asarray(src[:, :2]), jnp.asarray(dst_xy),
            jnp.asarray(weights)))
        assert abs(p[2] - s) < 1e-3
        assert abs(p[0] - 2.0) < 1e-3 and abs(p[1] + 1.0) < 1e-3
        np.testing.assert_allclose(p[3:], [np.sin(th), np.cos(th)],
                                   atol=1e-4)
        np.testing.assert_allclose(p, pj, rtol=1e-4, atol=1e-6)
        q = similarity_3d_7p(t(src), t(dst), t(weights)).numpy()
        qj = np.asarray(jest.similarity_3d_7p(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(weights)))
        assert abs(q[6] - 1.05) < 1e-2
        np.testing.assert_allclose(q[:3], [1.0, 2.0, 3.0], atol=0.05)
        np.testing.assert_allclose(q, qj, rtol=1e-4, atol=1e-6)
