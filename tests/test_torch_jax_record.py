"""The JAX package's accuracy record on the bench pair with the dense FPFH
and RoPS settings that ``chip_smoke.py`` runs the port at (its phase 7),
RANSAC's odds on these lanes, and both packages' dense and streaming
engines on the engine inputs of phase 8's none + KM runs (chip_smoke.py
holds the card's poses to the JAX poses printed here).  The reference
beside which the card's poses are read (accuracy only: the JAX package
runs its XLA lane on the CPU here, so no time it prints is a device
time).

Minutes a run on a CPU, hence ``slow``:

    JAX_PLATFORMS=cpu python -m pytest -n 0 -s -m slow tests/test_torch_jax_record.py

Each registration prints one ``JAX record`` line (keypoints, iterations,
pose error); the RANSAC test one ``RANSAC`` line a seed and package.  With
no frame hypotheses on these lanes, RANSAC draws triples of candidate
pairs only, and at the default 2^17 hypotheses a seed may find no
consensus: the record holds the 2^20 runs to the bound."""
import dataclasses
import json
import pathlib

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


# the engine inputs of chip_smoke.py phase 8's dense none + KM run (bench
# pair, NMS 0.5 m, from its perturbed truth), written on the card by
# ``chip_smoke.py --save-engine-inputs``; chip_smoke.py's JAX_NONE_KM holds
# the JAX poses these tests print
NONE_KM_INPUTS = pathlib.Path(__file__).parent / "data" / "bench_none_km.npz"


@pytest.mark.slow
@pytest.mark.parametrize("converge", [True, False])
def test_jax_none_km_on_the_port_keypoints(converge):
    """Both packages' dense engines, on a CPU, on the keypoints the port
    took on the card (6605 / 6533 in 8192 slots), feature none + KM from
    the truth perturbed by 2 deg and (0.3, -0.2, 0.05) m: with the
    convergence test, and 60 iterations without it.  No final resolve
    (the pose does not depend on it; its 3000 rounds at 8192^2 take long
    on a CPU).  Prints one ``JAX record`` line a package.  Both stall a
    third of a metre from the truth (the complete one-to-one matching of a
    partial-overlap pair), and their poses agree within 0.05 deg / 0.03 m:
    the port takes its kernel lane here (K1 and the Gauss-Seidel phase,
    as on the card) and the JAX package its XLA lane (Jacobi rounds), two
    auctions that break ties apart, 2 cm apart after 60 iterations."""
    import jax.numpy as jnp

    import ghicp_tpu.registration.ghicp as jgh
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    d = np.load(NONE_KM_INPUTS)
    cfg = dataclasses.replace(BENCH, feature=FeatureType.NONE,
                              final_resolve_rounds=0)
    if not converge:
        cfg = dataclasses.replace(cfg, converge_translation=0.0,
                                  converge_rotation=0.0)
    fd = np.zeros((len(d["kp_s"]), len(d["kp_t"])), np.float32)
    args = [d[k] for k in ("kp_s", "mask_s", "kp_t", "mask_t")]
    J = jgh.ghicp_register_chunked(
        *(jnp.asarray(x) for x in args), jnp.asarray(fd),
        jnp.float32(d["bbx"]), cfg,
        init_transform=jnp.asarray(d["init_transform"]))
    M = ghicp_register_chunked(
        *args, fd, float(d["bbx"]),
        config_from_dict(dataclasses.asdict(cfg)),
        init_transform=d["init_transform"], device="cpu")
    poses = {}
    for name, T_est, its, cor in (
            ("JAX", np.asarray(J.transform), int(J.iterations),
             np.asarray(J.metrics.cor)),
            ("port", M.transform.numpy(), int(M.iterations),
             M.metrics.cor.numpy())):
        rot, tr = transform_error(T_est, d["T_gt"])
        poses[name] = T_est
        assert tr > 0.3, (name, rot, tr)
        print("JAX record", json.dumps(dict(
            package=name, feature="none", correspondence="km",
            start="perturbed truth", converge=converge, iterations=its,
            cor=cor[:its].tolist(), rot_err_deg=rot, t_err_m=tr,
            transform=T_est.tolist())), flush=True)
    rot, tr = transform_error(poses["port"], poses["JAX"])
    assert rot < 0.05 and tr < 0.03, (rot, tr)


@pytest.mark.slow
def test_streaming_none_km_on_the_port_keypoints():
    """Both packages' streaming lanes, on a CPU, on the same keypoints and
    start as ``test_jax_none_km_on_the_port_keypoints`` (the JAX package
    through ``stream_sweep_ref`` with its zero bit factors, the port
    through the plain K5-none).  Prints one ``JAX record`` line a package
    and each one's distance from the JAX package's dense pose; holds the
    two streaming poses to the lane criterion between them, 0.5 deg /
    0.1 m (tests/test_stream_engine.py:53-54)."""
    import jax.numpy as jnp

    import ghicp_tpu.registration.ghicp as jgh
    from ghicp_tpu.ops.stream_kernel import StreamFeatures
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.ops.stream_kernel import NoFeatures
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    d = np.load(NONE_KM_INPUTS)
    cap = len(d["kp_s"])
    cfg = dataclasses.replace(BENCH, feature=FeatureType.NONE,
                              streaming_cost="on", final_resolve_rounds=0)
    args = [d[k] for k in ("kp_s", "mask_s", "kp_t", "mask_t")]
    jargs = [jnp.asarray(x) for x in args]
    # the JAX pipeline's none factors (pipeline.py:383-391)
    zeros = StreamFeatures(fs=jnp.zeros((1, cap, 128), jnp.bfloat16),
                           ft=jnp.zeros((cap, 128), jnp.bfloat16),
                           na=jnp.zeros((1, cap)), nb=jnp.zeros((cap,)))
    J = jgh.ghicp_register_chunked(
        *jargs, None, jnp.float32(d["bbx"]), cfg,
        init_transform=jnp.asarray(d["init_transform"]), stream=zeros)
    D = jgh.ghicp_register_chunked(
        *jargs, jnp.zeros((cap, cap), jnp.float32), jnp.float32(d["bbx"]),
        dataclasses.replace(cfg, streaming_cost="auto"),
        init_transform=jnp.asarray(d["init_transform"]))
    M = ghicp_register_chunked(
        *args, None, float(d["bbx"]),
        config_from_dict(dataclasses.asdict(cfg)),
        init_transform=d["init_transform"], device="cpu",
        stream=NoFeatures(cap))
    dense = np.asarray(D.transform)
    poses = {}
    for name, T_est, its, cor in (
            ("JAX", np.asarray(J.transform), int(J.iterations),
             np.asarray(J.metrics.cor)),
            ("port", M.transform.numpy(), int(M.iterations),
             M.metrics.cor.numpy())):
        rot, tr = transform_error(T_est, d["T_gt"])
        rot_d, tr_d = transform_error(T_est, dense)
        poses[name] = T_est
        print("JAX record", json.dumps(dict(
            package=name, lane="streaming", feature="none",
            correspondence="km", start="perturbed truth", iterations=its,
            cor=cor[:its].tolist(), rot_err_deg=rot, t_err_m=tr,
            from_jax_dense_deg=rot_d, from_jax_dense_m=tr_d,
            transform=T_est.tolist())), flush=True)
    rot, tr = transform_error(poses["port"], poses["JAX"])
    assert rot < 0.5 and tr < 0.1, (rot, tr)


# the engine inputs of config 6's streaming none + NNR run, cut to 16,384
# keypoint slots (NMS 0.3 m), from its perturbed truth, written on the card
# by ``chip_smoke.py --save-engine-inputs``
CONFIG6_INPUTS = pathlib.Path(__file__).parent / "data" / "config6_none_nnr.npz"


def _jax_config(d: dict) -> GHICPConfig:
    """The JAX package's config from the port's ``config_to_dict`` fields
    (those it has)."""
    enums = {"feature": FeatureType, "correspondence": CorrespondenceType}
    return GHICPConfig(**{f.name: enums.get(f.name, lambda v: v)(d[f.name])
                          for f in dataclasses.fields(GHICPConfig)
                          if f.name in d})


@pytest.mark.slow
def test_config6_none_nnr_on_the_port_keypoints():
    """Both packages' streaming none + NNR engines, on a CPU, on config 6's
    engine inputs as the port took them on the card (cut to 16,384 slots):
    the JAX package through ``stream_sweep_ref`` with its zero bit factors
    and the column side, the port through the plain K5-none-col.  Prints one
    ``JAX record`` line a package (with its distance from the card's pose)
    and holds the two poses within 0.5 deg / 0.1 m of each other: where they
    agree, config 6's none + NNR error is the design's, not the port's.  As
    a regression limit, within 0.05 deg / 0.01 m, ten times their measured
    distance (0.0000 deg / 0.0010 m), so that a change that moves the port's
    none + NNR lane away from the JAX package's fails here."""
    import jax.numpy as jnp

    import ghicp_tpu.registration.ghicp as jgh
    from ghicp_tpu.ops.stream_kernel import StreamFeatures
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.ops.stream_kernel import NoFeatures
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    d = np.load(CONFIG6_INPUTS)
    conf = json.loads(str(d["config"]))
    cap = len(d["kp_s"])
    args = [d[k] for k in ("kp_s", "mask_s", "kp_t", "mask_t")]
    zeros = StreamFeatures(fs=jnp.zeros((1, cap, 128), jnp.bfloat16),
                           ft=jnp.zeros((cap, 128), jnp.bfloat16),
                           na=jnp.zeros((1, cap)), nb=jnp.zeros((cap,)))
    J = jgh.ghicp_register_chunked(
        *(jnp.asarray(x) for x in args), None, jnp.float32(d["bbx"]),
        _jax_config(conf), init_transform=jnp.asarray(d["init_transform"]),
        it_shift=float(d["it_shift"]), stream=zeros)
    M = ghicp_register_chunked(
        *args, None, float(d["bbx"]), config_from_dict(conf),
        init_transform=d["init_transform"], it_shift=float(d["it_shift"]),
        device="cpu", stream=NoFeatures(cap))
    poses = {}
    for name, T_est, its, cor in (
            ("JAX", np.asarray(J.transform), int(J.iterations),
             np.asarray(J.metrics.cor)),
            ("port", M.transform.numpy(), int(M.iterations),
             M.metrics.cor.numpy())):
        rot, tr = transform_error(T_est, d["T_gt"])
        rot_c, tr_c = transform_error(T_est, d["transform"])
        poses[name] = T_est
        print("JAX record", json.dumps(dict(
            package=name, lane="streaming", feature="none",
            correspondence="nnr", start="perturbed truth", slots=cap,
            keypoints=[int(d["mask_s"].sum()), int(d["mask_t"].sum())],
            iterations=its, cor=cor[:its].tolist(), rot_err_deg=rot,
            t_err_m=tr, from_card_deg=rot_c, from_card_m=tr_c,
            transform=T_est.tolist())), flush=True)
    rot, tr = transform_error(poses["port"], poses["JAX"])
    print("JAX record", json.dumps(dict(port_vs_jax_deg=rot,
                                        port_vs_jax_m=tr)), flush=True)
    assert rot < 0.5 and tr < 0.1, (rot, tr)
    assert rot < 0.05 and tr < 0.01, (rot, tr)


@pytest.mark.slow
def test_config6_none_km_on_the_port_keypoints():
    """Config 6's streaming none + KM (ROADMAP Queue 3: on the card it ends
    1.94 deg / 0.36 m from the truth at 51,200 slots) on the recorded
    feature-free engine inputs of ``test_config6_none_nnr_on_the_port_
    keypoints`` (16,384 slots, NMS 0.3 m, the perturbed truth), KM in place
    of NNR, without the final resolve (it leaves the pose as it is): the
    JAX package through ``stream_sweep_ref`` with its zero bit factors, the
    port through the plain K5-none.  One ``JAX record`` line a package and
    their distance; the rule: within 0.5 deg / 0.1 m of each other the
    error is the design's, not the port's."""
    import jax.numpy as jnp

    import ghicp_tpu.registration.ghicp as jgh
    from ghicp_tpu.ops.stream_kernel import StreamFeatures
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.ops.stream_kernel import NoFeatures
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    d = np.load(CONFIG6_INPUTS)
    conf = dict(json.loads(str(d["config"])), correspondence="km",
                final_resolve_rounds=0)
    cap = len(d["kp_s"])
    args = [d[k] for k in ("kp_s", "mask_s", "kp_t", "mask_t")]
    zeros = StreamFeatures(fs=jnp.zeros((1, cap, 128), jnp.bfloat16),
                           ft=jnp.zeros((cap, 128), jnp.bfloat16),
                           na=jnp.zeros((1, cap)), nb=jnp.zeros((cap,)))
    J = jgh.ghicp_register_chunked(
        *(jnp.asarray(x) for x in args), None, jnp.float32(d["bbx"]),
        _jax_config(conf), init_transform=jnp.asarray(d["init_transform"]),
        it_shift=float(d["it_shift"]), stream=zeros)
    M = ghicp_register_chunked(
        *args, None, float(d["bbx"]), config_from_dict(conf),
        init_transform=d["init_transform"], it_shift=float(d["it_shift"]),
        device="cpu", stream=NoFeatures(cap))
    poses = {}
    for name, T_est, its, cor in (
            ("JAX", np.asarray(J.transform), int(J.iterations),
             np.asarray(J.metrics.cor)),
            ("port", M.transform.numpy(), int(M.iterations),
             M.metrics.cor.numpy())):
        rot, tr = transform_error(T_est, d["T_gt"])
        poses[name] = T_est
        print("JAX record", json.dumps(dict(
            package=name, lane="streaming", feature="none",
            correspondence="km", start="perturbed truth", slots=cap,
            keypoints=[int(d["mask_s"].sum()), int(d["mask_t"].sum())],
            iterations=its, cor=cor[:its].tolist(), rot_err_deg=rot,
            t_err_m=tr, transform=T_est.tolist())), flush=True)
    rot, tr = transform_error(poses["port"], poses["JAX"])
    print("JAX record", json.dumps(dict(port_vs_jax_deg=rot,
                                        port_vs_jax_m=tr)), flush=True)
    assert rot < 0.5 and tr < 0.1, (rot, tr)


# The verdict run's engine inputs as the port took them on the card
# (``chip_smoke.py --save-engine-inputs``, phase 3, --seed 7): keypoints,
# masks, the BSC FD (uint16 Hamming distances), bounding box and RANSAC
# pose
VERDICT_INPUTS = pathlib.Path(__file__).parent / "data" / "verdict_bsc_km.npz"


@pytest.mark.slow
def test_verdict_trajectory_on_the_port_keypoints():
    """Both packages' dense BSC + KM engines, on a CPU, from the verdict
    run's engine inputs as the port took them on the card, each with its
    final resolve (ROADMAP Queue 3, the verdict trajectory): the JAX
    package in its kernel lane (K1-K3 in interpret mode, as on a TPU) and
    in the XLA lane it takes on a CPU (Jacobi rounds), the port in its
    kernel lane (as on the card).  One ``JAX record`` line a run, with its
    correspondences and RMSE an iteration, its pose error and its distance
    from the card's pose.  The port retraces the JAX kernel lane iteration
    by iteration (the same correspondences, RMSE within rtol 1e-5, the
    same iterations, as the card's run) and both lanes succeed within the
    verdict bound (< 0.5 deg / 0.1 m): a trajectory of another length comes
    from the lane (and, in the JAX record, from its own RANSAC draws)."""
    import jax
    import jax.numpy as jnp

    import ghicp_tpu.matching.auction as jau
    import ghicp_tpu.registration.ghicp as jgh
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked
    d = np.load(VERDICT_INPUTS)
    conf = json.loads(str(d["config"]))
    fd = d["fd"].astype(np.float32)
    args = [d[k] for k in ("kp_s", "mask_s", "kp_t", "mask_t")]

    def jax_run(kernels: bool):
        # the lane is read when the engine is traced: no cached trace of
        # the other lane may serve this run
        jax.clear_caches()
        old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
        jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = kernels
        try:
            return jgh.ghicp_register_chunked(
                *(jnp.asarray(x) for x in args), jnp.asarray(fd),
                jnp.float32(d["bbx"]), _jax_config(conf),
                init_transform=jnp.asarray(d["init_transform"]),
                it_shift=float(d["it_shift"]))
        finally:
            jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old
    M = ghicp_register_chunked(
        *args, fd, float(d["bbx"]), config_from_dict(conf),
        init_transform=d["init_transform"], it_shift=float(d["it_shift"]),
        device="cpu")
    runs = {}
    for name, res in (("JAX kernel lane", jax_run(True)),
                      ("JAX XLA lane", jax_run(False)),
                      ("port kernel lane", M)):
        its = int(res.iterations)
        met = res.metrics
        T_est = np.asarray(res.transform)
        rot, tr = transform_error(T_est, d["T_gt"])
        rot_c, tr_c = transform_error(T_est, d["transform"])
        runs[name] = dict(
            iterations=its, cor=np.asarray(met.cor)[:its].tolist(),
            rmse=[float(x) for x in np.asarray(met.rmse)[:its]],
            final_rmse=float(res.final_rmse), success=bool(res.success),
            rot_err_deg=rot, t_err_m=tr, from_card_deg=rot_c,
            from_card_m=tr_c)
        print("JAX record", json.dumps(dict(
            run=name, feature="bsc", correspondence="km", start="RANSAC",
            keypoints=[int(d["mask_s"].sum()), int(d["mask_t"].sum())],
            slots=len(d["kp_s"]), **runs[name])), flush=True)
    j, m = runs["JAX kernel lane"], runs["port kernel lane"]
    assert m["iterations"] == j["iterations"] == int(d["iterations"])
    assert m["cor"] == j["cor"]
    np.testing.assert_allclose(m["rmse"], j["rmse"], rtol=1e-5)
    for r in runs.values():
        assert r["success"] and r["rot_err_deg"] < 0.5 and r["t_err_m"] < 0.1
