"""The GH-ICP engine of both packages: one iteration from an identical state
(carried across with ``ghicp_tpu_torch.interop``) and a whole run, with the
JAX package's fused and GS kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core.comm import LOCAL
from ghicp_tpu.core.config import (CorrespondenceType, FeatureType,
                                   GHICPConfig)
from ghicp_tpu.registration.pipeline import transform_error
from ghicp_tpu_torch.interop import config_from_dict, state_from_numpy
from ghicp_tpu_torch.registration.ghicp import (ghicp_register_chunked,
                                                make_body)

torch.set_num_threads(1)
S = T = 1024
BASE = GHICPConfig(feature=FeatureType.BSC,
                   correspondence=CorrespondenceType.KM, max_iterations=6,
                   auction_max_rounds=4)


@pytest.fixture(scope="module")
def problem():
    return ge._registration_problem(S, T, seed=13)


@pytest.fixture
def interpret():
    old = (jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET)
    jgh._FUSED_INTERPRET = jau._KERNEL_INTERPRET = True
    try:
        yield
    finally:
        jgh._FUSED_INTERPRET, jau._KERNEL_INTERPRET = old


def _to_numpy(st):
    d = {f: np.asarray(getattr(st, f)) for f in st._fields
         if f not in ("metrics", "scarry")}
    d["metrics"] = {f: np.asarray(getattr(st.metrics, f))
                    for f in st.metrics._fields}
    return d


@pytest.mark.parametrize("start_it", [0, 2])
def test_one_iteration_from_identical_state(problem, interpret, start_it):
    """it 0 takes the full solve (K1 + K2), it 2 the warm kernel (K3)."""
    src, tgt, fd, _, _, _ = problem
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    body_j = jax.jit(jgh._make_body(jnp.asarray(tgt), jnp.asarray(ms),
                                    jnp.asarray(mt), jnp.asarray(fd),
                                    jnp.float32(40.0), BASE, LOCAL, S))
    st = jgh._initial_state(jnp.asarray(src), T, BASE)
    for _ in range(start_it):
        st = body_j(st)
    want = body_j(st)
    cfg = config_from_dict(dataclasses.asdict(BASE))
    body_t = make_body(torch.from_numpy(tgt), torch.from_numpy(ms),
                       torch.from_numpy(mt), torch.from_numpy(fd), 40.0, cfg)
    got = body_t(state_from_numpy(_to_numpy(st), "cpu",
                                  BASE.max_iterations))
    i = start_it
    assert int(got.metrics.cor[i]) == int(np.asarray(want.metrics.cor)[i])
    np.testing.assert_allclose(got.rt.numpy(), np.asarray(want.rt),
                               atol=1e-4)
    # rtol: the CD statistics are float32 sums over S*T pairs in another
    # order, and mean - 2 std cancels part of their magnitude
    np.testing.assert_allclose(float(got.pen_prev), float(want.pen_prev),
                               rtol=1e-3)


def test_whole_engine(problem, interpret):
    src, tgt, fd, _, _, T_gt = problem
    ms, mt = np.ones(S, bool), np.ones(T, bool)
    want = jgh.ghicp_register(jnp.asarray(src), jnp.asarray(ms),
                              jnp.asarray(tgt), jnp.asarray(mt),
                              jnp.asarray(fd), jnp.float32(40.0), BASE)
    cfg = config_from_dict(dataclasses.asdict(BASE))
    got = ghicp_register_chunked(src, ms, tgt, mt, fd, 40.0, cfg,
                                 device="cpu")
    Tj, Tt = np.asarray(want.transform), got.transform.numpy()
    rot, tr = transform_error(Tt, Tj)
    assert rot < 0.1 and tr < 0.02, (rot, tr)
    for T_est in (Tj, Tt):
        rot, tr = transform_error(T_est, T_gt)
        assert rot < 1.0 and tr < 0.2, (rot, tr)
    m = got.matches.numpy()
    m = m[m >= 0]
    assert len(m) > S // 2 and len(np.unique(m)) == len(m)
