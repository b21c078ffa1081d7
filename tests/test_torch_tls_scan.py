"""The simulated terrestrial-laser-scan pair (range falloff, per-origin
occlusion) of both packages: numpy code on both sides, so the same seed
gives the same arrays, bit for bit."""
import numpy as np
import torch

from ghicp_tpu.io.synthetic import make_tls_scan_pair as jax_pair
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.io.synthetic import tls_scan as jax_scan
from ghicp_tpu_torch.io.synthetic import make_tls_scan_pair, tls_scan

torch.set_num_threads(1)


def test_tls_scan_pair_equals_jax_at_50k_points():
    kw = dict(seed=9, n_points=50_000, extent=25.0, rot_deg=25.0,
              origin_a=(0.0, 0.0, 1.8), origin_b=(12.0, 9.0, 1.8))
    got, want = make_tls_scan_pair(**kw), jax_pair(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    src, tgt, T = got
    # two scans from two origins: different point sets, both well short of
    # the scene
    assert 0 < len(src) < 50_000 and 0 < len(tgt) < 50_000
    assert len(src) != len(tgt)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                               atol=1e-6)


def test_tls_scan_keeps_the_same_points():
    pts = structured_scene(np.random.default_rng(4), 20_000, extent=15.0,
                           asymmetric_walls=True)
    for origin in ((0.0, 0.0, 1.8), (6.0, -4.0, 1.2)):
        got = tls_scan(pts, origin, np.random.default_rng(1),
                       keep_target=0.45)
        want = jax_scan(pts, origin, np.random.default_rng(1),
                        keep_target=0.45)
        assert np.array_equal(got, want)
