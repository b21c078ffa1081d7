"""The streaming sweep (kernel K5's plain version), the matched-pair gathers
and the RANSAC candidate scan against the JAX package's
``ops/stream_kernel.py`` on the same inputs (BSC, V = 4 variants), the JAX
sweep kernel running in interpret mode."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ghicp_tpu.features.bsc import pack_bits as jax_pack_bits
from ghicp_tpu.ops.stream_kernel import make_stream_features as jax_feats
from ghicp_tpu.ops.stream_kernel import stream_feature_candidates as jax_cand
from ghicp_tpu.ops.stream_kernel import stream_selected as jax_selected
from ghicp_tpu.ops.stream_kernel import stream_sweep as jax_sweep
from ghicp_tpu.ops.stream_kernel import stream_sweep_ref as jax_sweep_ref
from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.interop import stream_features_from_numpy
from ghicp_tpu_torch.ops.stream_kernel import (make_stream_features,
                                               popcount32, stream_selected,
                                               stream_feature_candidates,
                                               stream_sweep,
                                               stream_sweep_plain,
                                               subset_rows, to_words)

torch.set_num_threads(1)
WED, WFD, SCALE = 0.7, 0.3, 0.08


@pytest.fixture(scope="module")
def problem():
    """tests/test_stream_kernel.py's kernel fixture (S = C = 256) with four
    source variants."""
    S, C, V, n_bits = 256, 256, 4, 441
    rng = np.random.default_rng(0)
    kp_s = rng.uniform(-10, 10, (S, 3)).astype(np.float32)
    kp_t = rng.uniform(-10, 10, (C, 3)).astype(np.float32)
    bits_s = (rng.random((V, S, n_bits)) < 0.3).astype(np.float32)
    bits_t = (rng.random((1, C, n_bits)) < 0.3).astype(np.float32)
    ms = rng.random(S) < 0.9
    mt = rng.random(C) < 0.9
    prices = rng.uniform(0, 3, C).astype(np.float32)
    acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S),
                    -1).astype(np.int32)
    acol[::17] = 2**30          # sink rows never match a column
    jf = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bits_s)),
                   packed_t=jax_pack_bits(jnp.asarray(bits_t)),
                   n_bits=n_bits)
    tf = stream_features_from_numpy(np.asarray(jf.fs), np.asarray(jf.ft),
                                    np.asarray(jf.na), np.asarray(jf.nb),
                                    n_bits)
    return dict(kp_s=kp_s, kp_t=kp_t, bits_s=bits_s, bits_t=bits_t, ms=ms,
                mt=mt, prices=prices, acol=acol, jf=jf, tf=tf,
                n_bits=n_bits)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_features_from_port_bits_equal_interop(problem):
    p = problem
    f = make_stream_features(pack_bits(_t(p["bits_s"])),
                             pack_bits(_t(p["bits_t"])))
    for a, b in zip(f[:4], p["tf"][:4]):
        assert torch.equal(a, b)
    assert f.words_s.shape == (4, 256, 14) and f.words_s.dtype == torch.int32
    np.testing.assert_array_equal(f.na.numpy(), np.asarray(p["jf"].na))
    words = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    assert popcount32(words).tolist() == [0, 1, 32, 2]
    assert to_words(words).tolist() == [0, 1, -1, -2147483647]


def test_sweep_matches_jax_kernel_and_ref(problem):
    p = problem
    jargs = (jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]), p["jf"],
             jnp.asarray(p["ms"]), jnp.asarray(p["mt"]),
             jnp.asarray(p["prices"]), jnp.asarray(p["acol"]), WED, WFD,
             SCALE)
    want_k = jax_sweep(*jargs, ts=128, tc=128, interpret=True)
    want_r = jax_sweep_ref(*jargs, tc=128)
    got = stream_sweep(_t(p["kp_s"]), _t(p["kp_t"]), p["tf"], _t(p["ms"]),
                       _t(p["mt"]), _t(p["prices"]), _t(p["acol"]), WED, WFD,
                       SCALE)
    for want in (want_k, want_r):
        for k in ("j1", "j2"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
        # v's: the ED cross term is three float32 products here and a
        # HIGHEST-precision dot there (a few ulps apart)
        for k in ("v1", "v2", "vsel"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-6)
        assert float(got.cnt) == float(want.cnt)
        # statistics: float64 sums here, float32 blocks there
        for k in ("cd_sum", "cd_sumsq", "cd_max", "ed_max", "b_max",
                  "fd_max"):
            np.testing.assert_allclose(float(getattr(got, k)),
                                       float(getattr(want, k)), rtol=1e-4)


def test_sweep_is_tile_independent(problem):
    """The column-block width of the plain version (the kernel's tiles and
    column splits alike) changes no output: the lowest-column tie rule
    makes the top-2 a function of the values alone."""
    p = problem
    args = (_t(p["kp_s"]), _t(p["kp_t"]), p["tf"], _t(p["ms"]), _t(p["mt"]),
            _t(p["prices"]), _t(p["acol"]), WED, WFD, SCALE)
    a = stream_sweep_plain(*args, tc=256)
    b = stream_sweep_plain(*args, tc=32)
    for k in ("v1", "j1", "v2", "j2", "vsel", "cnt", "cd_max", "b_max"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    # a row subset gives the same rows' results
    idx = torch.arange(3, 256, 5)
    c = stream_sweep_plain(args[0][idx], args[1], subset_rows(p["tf"], idx),
                           args[3][idx], args[4], args[5], args[6][idx],
                           WED, WFD, SCALE)
    for k in ("v1", "j1", "v2", "j2", "vsel"):
        assert torch.equal(getattr(c, k), getattr(a, k)[idx]), k


def test_sweep_raises_for_lanes_not_ported(problem):
    p = problem
    args = (_t(p["kp_s"]), _t(p["kp_t"]), p["tf"], _t(p["ms"]), _t(p["mt"]),
            _t(p["prices"]), _t(p["acol"]), WED, WFD, SCALE)
    for kw in ("mult_blend", "no_features", "col_side"):
        with pytest.raises(NotImplementedError):
            stream_sweep(*args, **{kw: True})


def test_selected_matches_jax(problem):
    p = problem
    tgt = np.random.default_rng(6).integers(0, 256, 256)
    want = jax_selected(jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]),
                        p["jf"], jnp.asarray(tgt), WED, WFD, SCALE)
    got = stream_selected(_t(p["kp_s"]), _t(p["kp_t"]), p["tf"], _t(tgt),
                          WED, WFD, SCALE)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_feature_candidates_match_jax(problem):
    p = problem
    cand, ok = jax_cand(p["jf"], jnp.asarray(p["ms"]), jnp.asarray(p["mt"]),
                        tc=128)
    got, got_ok = stream_feature_candidates(p["tf"], _t(p["ms"]),
                                            _t(p["mt"]), tc=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cand))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
