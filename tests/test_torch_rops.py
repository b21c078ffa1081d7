"""The port's RoPS descriptors and their similarity against the JAX
package's ``features/rops.py`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.types import PointCloud as JaxCloud
from ghicp_tpu.features.rops import rops_features as jax_rops
from ghicp_tpu.features.rops import rops_similarity_matrix as jax_sim
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.rops import (rops_features,
                                           rops_similarity_matrix)
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors

torch.set_num_threads(1)
RADIUS, K = 1.0, 128


@pytest.fixture(scope="module")
def descriptors():
    """Both packages' descriptors at every 40th point of a 6000-point
    scene (positions, with a few masked slots), and each keypoint's LRF
    eigenvalues (from the port's neighbor lists, in float64)."""
    pts = structured_scene(np.random.default_rng(11), 6000, extent=5.0)
    kp = pts[::40].astype(np.float32)
    mask = np.ones(len(kp), bool)
    mask[-4:] = False
    jd = jax_rops(JaxCloud.from_points(pts), jnp.asarray(kp),
                  jnp.asarray(mask), radius=RADIUS, neighbor_k=K)
    cloud = PointCloud.from_points(pts)
    td = rops_features(cloud, torch.from_numpy(kp), torch.from_numpy(mask),
                       radius=RADIUS, neighbor_k=K)
    nb = radius_neighbors(PointCloud(xyz=torch.from_numpy(kp),
                                     mask=torch.from_numpy(mask)), cloud,
                          radius=RADIUS, k=K, cell_cap=max(K // 4, 16))
    d = np.where(nb.valid.numpy()[..., None],
                 cloud.xyz.numpy()[nb.idx.numpy()] - kp[:, None], 0.0)
    w = np.where(nb.valid.numpy(),
                 np.maximum(RADIUS - np.linalg.norm(d, axis=-1), 0.0), 0.0)
    cov = np.einsum("sk,ski,skj->sij", w, d, d)
    lam = np.linalg.eigvalsh(cov.astype(np.float64))[:, ::-1]
    return dict(jd=np.array(jd.desc), td=td.desc.numpy(), mask=mask,
                lam=lam)


def test_rops_features_match_jax(descriptors):
    """rtol 1e-4 on the keypoints whose frame is defined: LRF eigenvalue
    gaps above 1e-3 relative (a near-double root leaves the frame's axes
    to the rounding in either package)."""
    d = descriptors
    lam = d["lam"]
    gap = np.minimum(lam[:, 0] - lam[:, 1], lam[:, 1] - lam[:, 2])
    clear = d["mask"] & (gap > 1e-3 * lam[:, 0])
    assert d["td"].shape == (len(d["mask"]), 135)
    assert clear.mean() > 0.8
    np.testing.assert_allclose(d["td"][clear], d["jd"][clear], rtol=1e-4,
                               atol=1e-6)
    assert not d["td"][~d["mask"]].any()


def test_rops_similarity_matches_jax(descriptors):
    d = descriptors
    a, b = d["jd"], np.ascontiguousarray(d["jd"][::-1])
    want = np.asarray(jax_sim(jnp.asarray(a), jnp.asarray(b)))
    got = rops_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    live = d["mask"]
    same = rops_similarity_matrix(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(np.diag(same.numpy())[live], 1.0, atol=1e-5)
