"""The port's SOR, distance and bounding-box filters against the JAX
package's: equal masks on the same clouds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.preprocess import filters as jfl
from ghicp_tpu_torch.core.types import PointCloud
from ghicp_tpu_torch.preprocess import filters as tfl

torch.set_num_threads(1)


def _clouds(pts, capacity=None):
    return (JCloud.from_points(pts, capacity=capacity),
            PointCloud.from_points(pts, capacity=capacity))


@pytest.mark.parametrize("seed,mean_k,std_mul,radius", [
    (0, 16, 2.0, 1.0), (1, 50, 1.0, 0.8), (2, 8, 0.5, 0.5)])
def test_sor_filter_masks_equal(seed, mean_k, std_mul, radius):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0, 5, (2000, 3)).astype(np.float32)
    outliers = np.float32([[50, 50, 50], [60, -40, 10], [-30, 70, 5]])
    pts = np.concatenate([dense, outliers])
    jc, tc = _clouds(pts)
    want = np.asarray(jfl.sor_filter(jc, mean_k=mean_k, std_mul=std_mul,
                                     radius=radius).mask)
    got = tfl.sor_filter(tc, mean_k=mean_k, std_mul=std_mul, radius=radius)
    np.testing.assert_array_equal(got.mask.numpy(), want)
    assert got.xyz is tc.xyz
    assert not want[2000:2003].any() and want[:2000].sum() > 1000


def test_distance_filter_masks_equal():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-8, 8, (3000, 3)).astype(np.float32)
    pts[:4] = [[1, 0, 1], [10, 0, 1], [1, 0, 9], [0, 2, -5]]
    jc, tc = _clouds(pts)
    for args in ((5.0, 0.0, 5.0), (7.3, -2.5, 3.3), (0.1, -8.0, 8.0)):
        want = np.asarray(jfl.distance_filter(jc, *args).mask)
        got = tfl.distance_filter(tc, *args).mask.numpy()
        np.testing.assert_array_equal(got, want)
    assert tfl.distance_filter(tc, 5.0, 0.0, 5.0).mask[:4].tolist() == [
        True, False, False, False]


def test_bbx_filter_masks_equal():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 10, (3000, 3)).astype(np.float32)
    lo = np.float32([[4, 4, 4], [0, 0, 0], [7, 1, 2]])
    hi = np.float32([[6, 6, 6], [2, 3, 10], [9.5, 4, 3]])
    jc, tc = _clouds(pts, capacity=4096)
    want = np.asarray(jfl.bbx_filter(jc, jnp.asarray(lo),
                                     jnp.asarray(hi)).mask)
    got = tfl.bbx_filter(tc, lo, hi).mask.numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[3000:].any() and 0 < got.sum() < 3000
