"""The engine's iteration callback fires where the JAX package's chunked
loop calls it (every ``chunk`` iterations and at the loop's end),
and ``RegistrationOutput.final_correspondences`` is the JAX package's."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.registration.pipeline import \
    RegistrationOutput as JRegistrationOutput
from ghicp_tpu_torch.interop import config_from_dict
from ghicp_tpu_torch.io.synthetic import registration_problem
from ghicp_tpu_torch.registration.ghicp import (ghicp_register,
                                                ghicp_register_chunked)
from ghicp_tpu_torch.registration.pipeline import RegistrationOutput

torch.set_num_threads(1)
CHUNK = 4


def _problem(rot_deg):
    src, tgt, fd, _, _, _ = registration_problem(512, 512, seed=13,
                                                 rot_deg=rot_deg)
    ms, mt = np.ones(512, bool), np.ones(512, bool)
    ms[-16:] = False
    return src, tgt, np.zeros_like(fd), ms, mt


@pytest.fixture(scope="module")
def small():
    return _problem(6.0)


def _record(calls):
    return lambda it, kps, matches: calls.append((it, kps, matches))


@pytest.mark.parametrize("case", ["ends-on-a-boundary", "converges-inside"])
def test_callback_iterations_equal_jax(case):
    """At 6 degrees with the convergence test off the run ends at its
    8-iteration limit; at 15 degrees it converges after 7 iterations."""
    src, tgt, fd, ms, mt = _problem(6.0 if case == "ends-on-a-boundary"
                                    else 15.0)
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NN,
                      max_iterations=40, engine_chunk=CHUNK)
    if case == "ends-on-a-boundary":
        cfg = dataclasses.replace(cfg, max_iterations=8,
                                  converge_translation=0.0,
                                  converge_rotation=0.0)
    jcalls, tcalls = [], []
    want = jgh.ghicp_register_chunked(
        jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt), jnp.asarray(mt),
        jnp.asarray(fd), jnp.float32(40.0), cfg, chunk=CHUNK,
        iteration_callback=_record(jcalls))
    got = ghicp_register_chunked(
        src, ms, tgt, mt, fd, 40.0, config_from_dict(dataclasses.asdict(cfg)),
        chunk=CHUNK, device="cpu", iteration_callback=_record(tcalls))
    n = int(want.iterations)
    assert got.iterations == n
    if case == "ends-on-a-boundary":
        assert n == 8
    else:
        assert n < cfg.max_iterations and n % CHUNK, n
    its = [c[0] for c in tcalls]
    assert its == [c[0] for c in jcalls]
    assert its == list(range(CHUNK, n + 1, CHUNK)) + (
        [n] if n % CHUNK else [])
    for (_, tk, tm), (_, jk, jm) in zip(tcalls, jcalls):
        np.testing.assert_allclose(tk, np.asarray(jk), atol=1e-4)
        np.testing.assert_array_equal(tm, np.asarray(jm))


def test_unchunked_engine_reports_on_the_same_cadence(small):
    """``ghicp_register`` (no final matching) runs the same loop: a call
    every ``engine_chunk`` iterations and one at its end."""
    src, tgt, fd, ms, mt = small
    cfg = GHICPConfig(feature=FeatureType.NONE,
                      correspondence=CorrespondenceType.NN,
                      max_iterations=6, converge_translation=0.0,
                      converge_rotation=0.0, engine_chunk=CHUNK)
    calls = []
    ghicp_register(src, ms, tgt, mt, fd, 40.0,
                   config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                   iteration_callback=_record(calls))
    assert [c[0] for c in calls] == [4, 6]


def test_final_correspondences_equal_jax():
    rng = np.random.default_rng(3)
    kps = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    kpt = rng.uniform(0, 10, (30, 3)).astype(np.float32)
    matches = np.full(48, -1, np.int64)       # engine rows past the valid
    matches[:40:3] = rng.permutation(30)[:14]
    matches[44] = 7                           # a padded row: not reported
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = [1.0, 2.0, 3.0]
    kw = dict(transform=T, n_source_down=0, n_target_down=0,
              n_source_keypoints=40, n_target_keypoints=30, timings={},
              keypoints_source=kps, keypoints_target=kpt)
    want = JRegistrationOutput(
        result=types.SimpleNamespace(matches=jnp.asarray(matches)),
        **kw).final_correspondences()
    got = RegistrationOutput(
        result=types.SimpleNamespace(matches=torch.from_numpy(matches)),
        **kw).final_correspondences()
    assert got.shape == (14, 8) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
