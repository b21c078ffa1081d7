"""The JAX package's accuracy record on the bench pair with the dense FPFH
and RoPS settings that ``chip_smoke.py`` runs the port at (its phase 7),
and RANSAC's odds on these lanes.  The reference beside which the card's
poses are read (accuracy only: the JAX package runs its XLA lane on the
CPU here, so no time it prints is a device time).

Minutes a run on a CPU, hence ``slow``:

    JAX_PLATFORMS=cpu python -m pytest -s -m slow tests/test_torch_jax_record.py

Each registration prints one ``JAX record`` line (keypoints, iterations,
pose error); the RANSAC test one ``RANSAC`` line a seed and package.  With
no frame hypotheses on these lanes, RANSAC draws triples of candidate
pairs only, and at the default 2^17 hypotheses a seed may find no
consensus: the record holds the 2^20 runs to the bound."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bench import make_bench_pair
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
import ghicp_tpu.matching.ransac as jax_ransac
from ghicp_tpu.registration.pipeline import register_pair, transform_error
from ghicp_tpu_torch.matching.ransac import ransac_coarse_align

# bench.py's throughput settings (bench.py:151-158) with the feature set
BENCH = GHICPConfig(feature=FeatureType.BSC,
                    correspondence=CorrespondenceType.KM, voxel_size=0.1,
                    neighborhood_radius=0.5, non_max_radius=0.5,
                    min_neighbors=15, bsc_neighbor_k=256, pca_cell_cap=40,
                    pca_max_cells=65536, estimated_overlap=0.8,
                    max_iterations=60)
FEATURES = [FeatureType.FPFH, FeatureType.ROPS]


@pytest.mark.slow
@pytest.mark.parametrize("n_hyp", [1 << 17, 1 << 20])
@pytest.mark.parametrize("feature", FEATURES)
def test_jax_bench_pair_record(feature, n_hyp):
    src, tgt, T_gt = make_bench_pair()
    out = register_pair(src, tgt, dataclasses.replace(
        BENCH, feature=feature, ransac_hypotheses=n_hyp))
    rot, tr = transform_error(out.transform, T_gt)
    print("JAX record", json.dumps(dict(
        feature=feature.value, ransac_hypotheses=n_hyp,
        keypoints=[out.n_source_keypoints, out.n_target_keypoints],
        iterations=int(out.result.iterations), rot_err_deg=rot,
        t_err_m=tr, success=bool(out.success),
        final_rmse=float(out.final_rmse))), flush=True)
    if n_hyp == 1 << 20:
        assert rot < 1.5 and tr < 0.3, (rot, tr)


@pytest.mark.slow
@pytest.mark.parametrize("feature", FEATURES)
def test_ransac_seeds_on_the_same_candidates(feature, monkeypatch):
    """RANSAC of both packages, four seeds each at 2^17 hypotheses, on the
    inputs the JAX pipeline hands its RANSAC (keypoints, 1 - FD): how
    often a seed finds the consensus (at least ``ransac_min_inliers``
    inliers within 1.5 deg / 0.3 m of the truth)."""
    src, tgt, T_gt = make_bench_pair()
    seen = {}
    real = jax_ransac.ransac_coarse_align

    def spy(*a, **k):
        seen["args"], seen["kw"] = a, k
        return real(*a, **k)

    monkeypatch.setattr(jax_ransac, "ransac_coarse_align", spy)
    register_pair(src, tgt, dataclasses.replace(BENCH, feature=feature))
    a, kw = seen["args"], seen["kw"]
    t = [torch.from_numpy(np.array(x)) for x in a[:5]]
    found = []
    for seed in range(4):
        rj = real(*a, **dict(kw, seed=seed))
        rt = ransac_coarse_align(*t, tau=kw["tau"], n_hyp=kw["n_hyp"],
                                 n_cand=kw["n_cand"], seed=seed)
        for name, inl, T_est in (("JAX", int(rj.inliers),
                                  np.asarray(rj.transform)),
                                 ("port", rt.inliers, rt.transform.numpy())):
            rot, tr = transform_error(T_est, T_gt)
            ok = inl >= BENCH.ransac_min_inliers and rot < 1.5 and tr < 0.3
            found.append(ok)
            print("RANSAC", json.dumps(dict(
                feature=feature.value, package=name, seed=seed,
                inliers=inl, rot_err_deg=rot, t_err_m=tr)), flush=True)
    assert len(found) == 8
