"""``register_pair(profile_dir=...)``: a registration traced with
``torch.profiler`` writes a Chrome trace holding the pipeline's stage
ranges, and gives the untraced call's pose; the JAX package's positional
order holds for ``profile_dir``, ``iteration_callback`` and
``overhead_out``."""
import json

import numpy as np
import pytest
import torch

from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.registration.pipeline import register_pair

torch.set_num_threads(1)
STAGES = ("downsample", "keypoints", "features", "coarse_init", "register")


@pytest.fixture(scope="module")
def pair():
    pts = structured_scene(np.random.default_rng(2), 6000, extent=10.0)
    th = np.deg2rad(12.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    t = np.float32([0.6, -0.4, 0.1])
    src = ((pts - t) @ R).astype(np.float32)
    cfg = GHICPConfig(voxel_size=0.15, neighborhood_radius=0.5,
                      non_max_radius=1.0, min_neighbors=8,
                      estimated_overlap=0.9, max_iterations=20,
                      ransac_hypotheses=4096, pca_cell_cap=32,
                      engine_chunk=4)
    return src, pts, cfg


def test_traced_registration(pair, tmp_path):
    src, tgt, cfg = pair
    plain = register_pair(src, tgt, cfg, device="cpu")
    calls, over = [], {}
    traced = register_pair(src, tgt, cfg, None, None, str(tmp_path),
                           lambda it, kps, m: calls.append(it), over,
                           device="cpu")
    np.testing.assert_array_equal(traced.transform, plain.transform)
    assert traced.result.iterations == plain.result.iterations
    n = int(traced.result.iterations)
    assert calls == list(range(4, n + 1, 4)) + ([n] if n % 4 else [])
    assert over["dispatch_overhead"] > 0.0
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    for stage in STAGES:
        assert f"pipeline.{stage}" in names, stage
    # no device, no device events
    assert not any(e.get("cat") == "kernel" for e in events)
