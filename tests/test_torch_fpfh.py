"""The port's Jacobi eigensolver, neighbor-list PCA and FPFH histograms
against the JAX package's ``ops/eigh3.py``, ``preprocess/pca.py`` and
``features/fpfh.py`` on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.types import PointCloud as JaxCloud
from ghicp_tpu.features.fpfh import fpfh_features as jax_fpfh
from ghicp_tpu.features.fpfh import fpfh_similarity_matrix as jax_sim
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.ops.eigh3 import eigh3 as jax_eigh3
from ghicp_tpu.preprocess.neighbors import radius_neighbors as jax_nbrs
from ghicp_tpu.preprocess.pca import pca_from_neighbors as jax_pca
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.features.fpfh import (fpfh_features,
                                           fpfh_similarity_matrix)
from ghicp_tpu_torch.ops.eigh3 import eigh3
from ghicp_tpu_torch.preprocess.neighbors import radius_neighbors
from ghicp_tpu_torch.preprocess.pca import pca_from_neighbors

torch.set_num_threads(1)
RADIUS = 0.8


@pytest.fixture(scope="module")
def scene():
    """A 3000-point structured scene, its neighbor lists and both
    packages' neighbor-list PCA."""
    pts = structured_scene(np.random.default_rng(3), 3000, extent=4.0)
    jc, tc = JaxCloud.from_points(pts), PointCloud.from_points(pts)
    jn = jax_nbrs(jc, jc, radius=RADIUS, k=24, include_self=False)
    tn = radius_neighbors(tc, tc, radius=RADIUS, k=24, include_self=False)
    return dict(pts=pts, jc=jc, tc=tc, jn=jn, tn=tn, jp=jax_pca(jc, jn),
                tp=pca_from_neighbors(tc, tn))


def test_eigh3_matches_jax_signs_included():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4000, 3, 3)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1)
    A[:4] = np.diag([1.0, 1.0, 2.0]).astype(np.float32)   # a double root
    A[4:8] = np.diag([3.0, 0.0, 0.0]).astype(np.float32)  # rank one
    wj, vj = jax_eigh3(jnp.asarray(A))
    wt, vt = eigh3(torch.from_numpy(A))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(wj).max()))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5)
    # descending, orthonormal columns
    assert (np.diff(wt.numpy(), axis=-1) <= 0).all()
    eye = np.einsum("nji,njk->nik", vt.numpy(), vt.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)


def test_neighbor_sets_and_pca_normals_match_jax(scene):
    """Same neighbor sets; normals (signs included) where they are
    defined: at least 3 neighbors and a clear smallest eigenvalue."""
    s = scene
    n = len(s["pts"])
    jidx, jok = np.asarray(s["jn"].idx), np.asarray(s["jn"].valid)
    tidx, tok = s["tn"].idx.numpy(), s["tn"].valid.numpy()
    for i in range(n):
        assert set(jidx[i][jok[i]]) == set(tidx[i][tok[i]])
    jv = np.asarray(s["jp"].valid)
    np.testing.assert_array_equal(s["tp"].valid.numpy(), jv)
    ev = np.asarray(s["jp"].eigvals)
    clear = jv & (ev[:, 1] - ev[:, 2] > 1e-3 * ev[:, 0])
    assert clear[:n].mean() > 0.9
    np.testing.assert_allclose(s["tp"].normal.numpy()[clear],
                               np.asarray(s["jp"].normal)[clear], atol=1e-4)
    np.testing.assert_allclose(s["tp"].curvature.numpy()[jv],
                               np.asarray(s["jp"].curvature)[jv], atol=1e-5)


def test_fpfh_features_match_jax(scene):
    """33-bin rows within 1e-3 on at least 99.5 % of the points whose
    histogram rests on defined normals only (the point, its neighbors and
    theirs have 3 neighbors or more: with fewer, the covariance has rank 1
    and its normal is whichever unit vector the rounding picks, in either
    package); those points are most of the scene."""
    s = scene
    n = len(s["pts"])
    hj, vj = jax_fpfh(s["jc"], radius=RADIUS, k=24)
    ht, vt = fpfh_features(s["tc"], radius=RADIUS, k=24)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    v = np.asarray(vj)
    idx, ok = np.asarray(s["jn"].idx), np.asarray(s["jn"].valid)
    hop1 = v & np.all(~ok | v[idx], axis=1)
    hop2 = hop1 & np.all(~ok | hop1[idx], axis=1)
    assert hop2[:n].mean() > 0.85
    err = np.abs(ht.numpy() - np.asarray(hj)).max(axis=1)[:n][hop2[:n]]
    assert np.mean(err < 1e-3) >= 0.995, np.mean(err < 1e-3)
    blocks = ht.numpy()[:n][hop2[:n]].reshape(-1, 3, 11).sum(axis=-1)
    np.testing.assert_allclose(blocks, 100.0, rtol=1e-5)


def test_fpfh_similarity_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.gamma(2.0, 4.0, (200, 33)).astype(np.float32)
    b = np.concatenate([a[::2] + rng.normal(0, 1, (100, 33)),
                        rng.gamma(2.0, 4.0, (60, 33))]).astype(np.float32)
    b[-3:] = 0.0                                  # zero rows stay zero
    want = np.asarray(jax_sim(jnp.asarray(a), jnp.asarray(b)))
    got = fpfh_similarity_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6
    same = fpfh_similarity_matrix(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(np.diag(same.numpy()), 1.0, atol=1e-5)
