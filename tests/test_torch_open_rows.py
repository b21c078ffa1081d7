"""Rows left open by the streaming keep test, in both packages, on the same
engine inputs: the port's keypoints, BSC bits and RANSAC pose of the bench
pair (bench.py's throughput settings, 8192 keypoint slots) with the
streaming lane on.  Each solve's warm-start keep test decides which rows
keep their previous column; the rows it releases are the ones the bidding
sweeps (K5) must solve again, full-height while they outnumber the
compaction block (``stream_open_cap``).  The port reads them from its
engine metrics (``open_rows``), the JAX package from the open-row count at
the start of its bidding loop (``matching/stream_auction.py`` computes it
in the loop's condition, :438-456; the test records the loop's initial
carry).  Minutes on a CPU (the keypoint stage of 800,000-point clouds and
two streaming engines), hence ``slow``:

    JAX_PLATFORMS=cpu python -m pytest -n 0 -s -m slow tests/test_torch_open_rows.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)

# bench.py's throughput settings (bench.py:151-158), streaming, 10
# iterations with the convergence test off, no final resolve
CONFIG = GHICPConfig(feature=FeatureType.BSC,
                     correspondence=CorrespondenceType.KM, voxel_size=0.1,
                     neighborhood_radius=0.5, non_max_radius=0.5,
                     min_neighbors=15, bsc_neighbor_k=256, pca_cell_cap=40,
                     pca_max_cells=65536, estimated_overlap=0.8,
                     max_iterations=10, converge_translation=0.0,
                     converge_rotation=0.0, final_resolve_rounds=0,
                     streaming_cost="on")


class _Captured(Exception):
    pass


@pytest.mark.slow
def test_streaming_open_rows_in_both_packages(monkeypatch):
    """Prints one ``open rows`` line a package (rows open when bidding
    starts, each solve) and holds the port to the JAX package's counts on
    the same inputs: a port that releases rows the JAX package keeps has a
    fault of its own."""
    torch.set_num_threads(4)
    import jax
    import jax.numpy as jnp

    import ghicp_tpu.matching.stream_auction as jsa
    import ghicp_tpu.registration.ghicp as jgh
    import ghicp_tpu_torch.registration.pipeline as tpl
    from ghicp_tpu.ops.stream_kernel import make_stream_features as jax_feats
    from ghicp_tpu_torch.interop import config_from_dict
    from ghicp_tpu_torch.io.synthetic import bench_pair

    engine = tpl.ghicp_register_chunked
    seen = {}

    def spy(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        raise _Captured

    monkeypatch.setattr(tpl, "ghicp_register_chunked", spy)
    src, tgt, _ = bench_pair(seed=7)
    pcfg = config_from_dict(dataclasses.asdict(CONFIG))
    with pytest.raises(_Captured):
        tpl.register_pair(src, tgt, pcfg, device="cpu")
    kp_s, mask_s, kp_t, mask_t, fd, bbx, _ = seen["a"]
    kw = seen["kw"]
    feats = kw["stream"]
    init = kw["init_transform"]
    it_shift = kw["it_shift"]
    host = lambda x: np.asarray(torch.as_tensor(x).cpu())

    M = engine(kp_s, mask_s, kp_t, mask_t, fd, bbx, pcfg,
               init_transform=init, it_shift=it_shift, device="cpu",
               stream=feats)
    n = int(M.iterations)
    port = M.metrics.open_rows[:n].tolist()

    # the JAX engine on the same keypoints, bits and start; the open rows
    # of each solve from its bidding loop's initial carry
    opened = []
    while_loop = jax.lax.while_loop

    def spy_loop(cond, body, init_val):
        if cond.__module__ == jsa.__name__ and len(init_val) == 7:
            jax.debug.callback(lambda k: opened.append(int(k)),
                               jnp.sum(init_val[1] == -1))
        return while_loop(cond, body, init_val)

    monkeypatch.setattr(jax.lax, "while_loop", spy_loop)
    jax.clear_caches()
    u32 = lambda w: jnp.asarray(host(w).view(np.uint32))
    jf = jax_feats(packed_s=u32(feats.words_s),
                   packed_t=u32(feats.words_t)[None], n_bits=441)
    J = jgh.ghicp_register_chunked(
        *(jnp.asarray(host(x)) for x in (kp_s, mask_s, kp_t, mask_t)), None,
        jnp.float32(bbx), CONFIG,
        init_transform=jnp.asarray(host(init).astype(np.float32)),
        it_shift=float(it_shift), stream=jf)
    jax.effects_barrier()
    n_j = int(J.iterations)
    valid = int(host(mask_s).sum())
    for name, rows, its in (("JAX", opened[:n_j], n_j), ("port", port, n)):
        print("open rows", json.dumps(dict(
            package=name, iterations=its, valid_rows=valid,
            open_rows=rows)), flush=True)
    assert n == n_j and len(opened) >= n_j
    # the same solves open the same rows, give or take the few rows whose
    # keep test sits on a float tie between the two packages' sweeps
    tol = max(8, valid // 200)
    assert all(abs(a - b) <= tol for a, b in zip(port, opened)), (
        port, opened[:n_j])
