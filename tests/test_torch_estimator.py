"""Rigid estimators of the port against scipy's rotation oracle, and
against the JAX package away from 180 degrees."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ghicp_tpu.registration.estimator import estimate as jax_estimate
from ghicp_tpu_torch.registration.estimator import estimate, yaw_4dof

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
