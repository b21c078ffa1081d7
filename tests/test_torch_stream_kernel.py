"""The streaming sweep (kernel K5's plain version), the matched-pair gathers
and the RANSAC candidate scan against the JAX package's
``ops/stream_kernel.py`` on the same inputs (BSC, V = 4 variants; the
similarity and none lanes; the column side of each), the JAX sweep kernel
running in interpret mode."""
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
from ghicp_tpu_torch.interop import (desc_features_from_numpy,
                                     stream_features_from_numpy)
from ghicp_tpu_torch.ops.stream_kernel import (NoFeatures,
                                               make_desc_features,
                                               make_stream_features,
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


# ---------------------------------------------------------------------------
# the none lane and the column side (every lane)
# ---------------------------------------------------------------------------

DUP = (slice(200, 220), slice(10, 30))   # source rows 200-219 copy 10-29


@pytest.fixture(scope="module")
def col_problem():
    """S = C = 256 with planted exact column ties: source rows 200-219
    duplicate rows 10-29 (coordinates, BSC bits, descriptors), so a column
    whose least CD lies on one of them has it at two rows; the lower one
    must win."""
    S = C = 256
    rng = np.random.default_rng(11)
    kp_s = rng.uniform(-10, 10, (S, 3)).astype(np.float32)
    kp_t = rng.uniform(-10, 10, (C, 3)).astype(np.float32)
    kp_s[DUP[0]] = kp_s[DUP[1]]
    bits_s = (rng.random((4, S, 441)) < 0.3).astype(np.float32)
    bits_s[:, DUP[0]] = bits_s[:, DUP[1]]
    bits_t = (rng.random((1, C, 441)) < 0.3).astype(np.float32)
    desc_t = rng.gamma(2.0, 5.0, (C, 33)).astype(np.float32)
    desc_s = (desc_t[rng.integers(0, C, S)]
              + rng.normal(0, 2.0, (S, 33))).astype(np.float32)
    desc_s[DUP[0]] = desc_s[DUP[1]]
    ms, mt = rng.random(S) < 0.9, rng.random(C) < 0.9
    ms[DUP[0]] = ms[DUP[1]] = True
    prices = rng.uniform(0, 3, C).astype(np.float32)
    acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S),
                    -1).astype(np.int32)
    jb = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bits_s)),
                   packed_t=jax_pack_bits(jnp.asarray(bits_t)), n_bits=441)
    jd = jax_feats(desc_s=jnp.asarray(desc_s), desc_t=jnp.asarray(desc_t))
    lanes = {
        "hamming": (jb, stream_features_from_numpy(
            np.asarray(jb.fs), np.asarray(jb.ft), np.asarray(jb.na),
            np.asarray(jb.nb)), WED, WFD, {}),
        "similarity": (jd, desc_features_from_numpy(
            np.asarray(jd.fs), np.asarray(jd.ft), 33), 1.0, K_MULT,
            dict(mult_blend=True)),
        "none": (jb, NoFeatures(S), WED, 0.0, dict(no_features=True)),
    }
    return dict(kp_s=kp_s, kp_t=kp_t, ms=ms, mt=mt, prices=prices,
                acol=acol, bits_s=bits_s, bits_t=bits_t, lanes=lanes)


def _col_args(p, lane):
    jf, tf, wed, wfd, kw = p["lanes"][lane]
    jargs = (jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]), jf,
             jnp.asarray(p["ms"]), jnp.asarray(p["mt"]),
             jnp.asarray(p["prices"]), jnp.asarray(p["acol"]), wed, wfd,
             SCALE)
    targs = (_t(p["kp_s"]), _t(p["kp_t"]), tf, _t(p["ms"]), _t(p["mt"]),
             _t(p["prices"]), _t(p["acol"]), wed, wfd, SCALE)
    # the port takes the none lane from the type of its features
    return jargs, targs, kw, {k: v for k, v in kw.items()
                              if k != "no_features"}


LANES = ["hamming", "similarity", "none"]


@pytest.mark.parametrize("lane", LANES)
def test_sweep_col_side_matches_jax_ref(col_problem, lane):
    """Every lane with ``col_side`` (the none lane with ``no_features``
    on the JAX side, ``NoFeatures`` on the port's) against ``stream_sweep_ref``: v1/v2/vsel within the file's tolerances
    (rtol 1e-6 on the Hamming lane, whose CD the integer FD dominates;
    rtol 1e-5 and atol 5e-5 where the nearest pair's norm-expansion ED, an
    absolute accuracy, is most of it, and the similarity's dot product
    sums in another order there); cmin within the same tolerances (the
    same nearest pairs); crow
    equal on every column whose two least CDs differ by more than 1e-5
    relative and on the planted exact ties, which the lower row wins."""
    p = col_problem
    jargs, targs, jkw, kw = _col_args(p, lane)
    want = jax_sweep_ref(*jargs, tc=128, col_side=True, **jkw)
    got = stream_sweep(*targs, col_side=True, **kw)
    tol = (dict(rtol=1e-6) if lane == "hamming"
           else dict(rtol=1e-5, atol=5e-5))
    for k in ("v1", "v2", "vsel"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), **tol)
    assert float(got.cnt) == float(want.cnt)
    for k in ("cd_sum", "cd_sumsq", "cd_max", "ed_max", "fd_max"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want, k)), rtol=1e-4)
    cmin_w, crow_w = np.asarray(want.cmin), np.asarray(want.crow)
    np.testing.assert_allclose(got.cmin.numpy(), cmin_w, **tol)
    # the second least CD of each column, from the same inputs
    cd = _dense_cd(p, lane, targs)
    m = p["ms"][:, None] & p["mt"][None, :]
    srt = np.sort(np.where(m, cd, 3e38), axis=0)
    clear = (srt[1] - srt[0]) > 1e-5 * np.abs(srt[0]) + 1e-30
    dup_lo = np.arange(DUP[1].start, DUP[1].stop)
    tied = np.isin(crow_w, dup_lo)
    assert tied.sum() > 0 and clear.mean() > 0.5
    crow = got.crow.numpy()
    np.testing.assert_array_equal(crow[clear | tied], crow_w[clear | tied])
    assert not np.isin(crow, np.arange(DUP[0].start, DUP[0].stop)).any()
    empty = ~p["mt"]
    assert (crow[empty] == 2**30).all() and (got.cmin.numpy()[empty]
                                             == np.float32(3e38)).all()


def _dense_cd(p, lane, targs):
    """The lane's CD [S, C], dense, from the plain version's pieces."""
    from ghicp_tpu_torch.ops.cost_kernel import (_factors, factor_cost,
                                                 factor_ed)
    from ghicp_tpu_torch.ops.stream_kernel import (_ham_block, _sim_block,
                                                   unpack_words)
    ks, kt = _factors(targs[0]), _factors(targs[1])
    f, wed, wfd = targs[2], targs[7], targs[8]
    if lane == "none":
        return (np.float32(wed) * factor_ed(ks, kt, SCALE)).numpy()
    if lane == "similarity":
        return factor_cost(ks, kt, _sim_block(f.fs, f.ft, f.dim), wed, wfd,
                           SCALE, True)[1].numpy()
    fd = _ham_block(unpack_words(f.words_s), f.na, unpack_words(f.words_t),
                    f.nb)
    return factor_cost(ks, kt, fd, wed, wfd, SCALE)[1].numpy()


@pytest.mark.parametrize("lane", LANES)
def test_sweep_col_side_is_tile_independent(col_problem, lane):
    """cmin / crow (and every other output) do not depend on the column
    block width, and ``col_side`` changes none of the other outputs."""
    _, targs, _, kw = _col_args(col_problem, lane)
    a = stream_sweep_plain(*targs, tc=256, col_side=True)
    b = stream_sweep_plain(*targs, tc=48, col_side=True)
    c = stream_sweep_plain(*targs, tc=100)
    for k in ("v1", "j1", "v2", "j2", "vsel", "cnt", "cd_max", "b_max",
              "cmin", "crow"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("v1", "j1", "v2", "j2", "vsel", "cnt", "ed_max", "fd_max"):
        assert torch.equal(getattr(a, k), getattr(c, k)), k
    assert c.cmin is None and c.crow is None
    with pytest.raises(TypeError):
        stream_sweep(*targs, mult_blend=not kw.get("mult_blend", False))


def test_col_side_matches_dense_argmin():
    """tests/test_stream_engine.py's column-side check on the port: the
    per-column least CD and its lowest row against a dense numpy
    min / argmin (BSC, two source variants)."""
    rng = np.random.default_rng(5)
    S, C, n_bits = 192, 256, 441
    kp_s = rng.uniform(0, 10, (S, 3)).astype(np.float32)
    kp_t = rng.uniform(0, 10, (C, 3)).astype(np.float32)
    bits_s = (rng.random((2, S, n_bits)) < 0.3).astype(np.float32)
    bits_t = (rng.random((1, C, n_bits)) < 0.3).astype(np.float32)
    feats = make_stream_features(pack_bits(_t(bits_s).long()),
                                 pack_bits(_t(bits_t).long()))
    ms, mt = rng.random(S) < 0.9, rng.random(C) < 0.9
    wed, wfd, scale = 0.4, 0.6, 0.21
    sw = stream_sweep_plain(_t(kp_s), _t(kp_t), feats, _t(ms), _t(mt),
                            torch.zeros(C), torch.full((S,), -1), wed, wfd,
                            scale, tc=64, col_side=True)
    ham = np.stack([bits_s[v].sum(1)[:, None] + bits_t[0].sum(1)[None, :]
                    - 2.0 * bits_s[v] @ bits_t[0].T for v in range(2)])
    ed = scale * np.linalg.norm(kp_s[:, None] - kp_t[None], axis=-1)
    cd = wed * ed + wfd * ham.min(0)
    cdm = np.where(ms[:, None] & mt[None, :], cd, 3.0e38)
    cmin_ref = cdm.min(0)
    crow_ref = np.where(cmin_ref < 3.0e38, cdm.argmin(0), 2**30)
    np.testing.assert_allclose(sw.cmin.numpy(), cmin_ref, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(sw.crow.numpy(), crow_ref)


def test_selected_no_features_matches_jax(col_problem):
    p = col_problem
    tgt = np.random.default_rng(12).integers(0, 256, 256)
    jf, tf, _, _, _ = p["lanes"]["none"]
    want = jax_selected(jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]), jf,
                        jnp.asarray(tgt), WED, 0.0, SCALE, no_features=True)
    got = stream_selected(_t(p["kp_s"]), _t(p["kp_t"]), tf, _t(tgt), WED,
                          0.0, SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert not got[2].any()


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


# ---------------------------------------------------------------------------
# the similarity (FPFH/RoPS, mult_blend) lane
# ---------------------------------------------------------------------------

K_MULT = 1.0 / 3.0


@pytest.fixture(scope="module")
def desc_problem(problem):
    """FPFH-like histograms (D = 33) and RoPS-like statistics (D = 135)
    whose matching rows correlate, on the BSC fixture's keypoints."""
    rng = np.random.default_rng(4)
    S = C = 256
    out = {}
    for name, D, std in (("rows", 33, "rows"), ("dims", 135, "dims")):
        base = rng.gamma(2.0, 5.0, (C, D)).astype(np.float32)
        perm = rng.permutation(C)[:S]
        desc_s = (base[perm] + rng.normal(0, 2.0, (S, D))).astype(np.float32)
        desc_s[-5:] = 0.0                       # zero rows (masked slots)
        desc_t = base
        jf = jax_feats(desc_s=jnp.asarray(desc_s), desc_t=jnp.asarray(desc_t),
                       standardize=std)
        out[name] = dict(desc_s=desc_s, desc_t=desc_t, jf=jf, std=std, D=D,
                         tf=desc_features_from_numpy(np.asarray(jf.fs),
                                                     np.asarray(jf.ft), D))
    return out


@pytest.mark.parametrize("std", ["rows", "dims"])
def test_desc_features_match_jax(desc_problem, std):
    """Standardized bf16 factor rows as the JAX package's: the float32
    means, variances and norms are sums in another order there, so a value
    that lands next to a bf16 rounding edge may round to the neighbouring
    bf16 value; at least 99.9 % of the entries are bit-equal, and every
    entry is within 1e-3 (a few bf16 steps of a small whitened value)."""
    d = desc_problem[std]
    f = make_desc_features(_t(d["desc_s"]), _t(d["desc_t"]), d["std"])
    assert f.dim == d["D"] and f.fs.shape == (256, 128 * -(-d["D"] // 128))
    for mine, theirs in ((f.fs, d["tf"].fs), (f.ft, d["tf"].ft)):
        assert mine.dtype == torch.bfloat16
        same = mine.view(torch.int16) == theirs.view(torch.int16)
        assert same.float().mean() >= 0.999
        np.testing.assert_allclose(mine.float().numpy(),
                                   theirs.float().numpy(), atol=1e-3)
        assert not mine[:, d["D"]:].any()


@pytest.mark.parametrize("std", ["rows", "dims"])
def test_sweep_mult_matches_jax_ref(problem, desc_problem, std):
    """K5's similarity lane against ``stream_sweep_ref(mult_blend=True)``
    on identical factors: v1/v2/vsel within rtol 1e-5 and atol 5e-5, j1
    equal wherever the top-2 gap exceeds 1e-4, the statistics rtol 1e-5
    (b_max atol 1e-5) and fd_max 0.  The absolute terms: a row's best
    value sits at its nearest pair, whose norm-expansion ED has only an
    absolute accuracy, and the dot product sums in another order there
    (the JAX package's own kernel and reference differ by 1.2e-5 in v1 on
    this input)."""
    p, d = problem, desc_problem[std]
    want = jax_sweep_ref(jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]),
                         d["jf"], jnp.asarray(p["ms"]), jnp.asarray(p["mt"]),
                         jnp.asarray(p["prices"]), jnp.asarray(p["acol"]),
                         1.0, K_MULT, SCALE, tc=128, mult_blend=True)
    got = stream_sweep(_t(p["kp_s"]), _t(p["kp_t"]), d["tf"], _t(p["ms"]),
                       _t(p["mt"]), _t(p["prices"]), _t(p["acol"]), 1.0,
                       K_MULT, SCALE, mult_blend=True)
    for k in ("v1", "v2", "vsel"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=5e-5)
    clear = np.asarray(want.v1 - want.v2) > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.j1.numpy()[clear],
                                  np.asarray(want.j1)[clear])
    assert float(got.cnt) == float(want.cnt)
    for k in ("cd_sum", "cd_sumsq", "cd_max", "ed_max"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want, k)), rtol=1e-5)
    np.testing.assert_allclose(float(got.b_max), float(want.b_max),
                               atol=1e-5)
    assert float(got.fd_max) == 0.0


def test_sweep_mult_is_tile_independent(problem, desc_problem):
    """The similarity lane's plain version gives the same bits for any
    column block and on a row subset (the kernel's tiles, column splits
    and compacted sweeps)."""
    p, d = problem, desc_problem["dims"]
    args = (_t(p["kp_s"]), _t(p["kp_t"]), d["tf"], _t(p["ms"]), _t(p["mt"]),
            _t(p["prices"]), _t(p["acol"]), 1.0, K_MULT, SCALE)
    a = stream_sweep_plain(*args, tc=256)
    b = stream_sweep_plain(*args, tc=48)
    for k in ("v1", "j1", "v2", "j2", "vsel", "cnt", "cd_max", "b_max"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    idx = torch.arange(1, 256, 3)
    c = stream_sweep_plain(args[0][idx], args[1], subset_rows(d["tf"], idx),
                           args[3][idx], args[4], args[5], args[6][idx],
                           1.0, K_MULT, SCALE)
    for k in ("v1", "j1", "v2", "j2", "vsel"):
        assert torch.equal(getattr(c, k), getattr(a, k)[idx]), k
    with pytest.raises(TypeError):
        stream_sweep(*args)                 # DescFeatures without mult_blend


def test_selected_mult_matches_jax(problem, desc_problem):
    p, d = problem, desc_problem["rows"]
    tgt = np.random.default_rng(8).integers(0, 256, 256)
    want = jax_selected(jnp.asarray(p["kp_s"]), jnp.asarray(p["kp_t"]),
                        d["jf"], jnp.asarray(tgt), 1.0, K_MULT, SCALE,
                        mult_blend=True)
    got = stream_selected(_t(p["kp_s"]), _t(p["kp_t"]), d["tf"], _t(tgt),
                          1.0, K_MULT, SCALE, mult_blend=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("std", ["rows", "dims"])
def test_feature_candidates_mult_match_jax(problem, desc_problem, std):
    p, d = problem, desc_problem[std]
    cand, ok = jax_cand(d["jf"], jnp.asarray(p["ms"]), jnp.asarray(p["mt"]),
                        mult_blend=True, tc=128)
    got, got_ok = stream_feature_candidates(d["tf"], _t(p["ms"]),
                                            _t(p["mt"]), mult_blend=True,
                                            tc=64)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(got.numpy()[:, 0], np.asarray(cand)[:, 0])
    assert np.mean(got.numpy()[:, 1] == np.asarray(cand)[:, 1]) >= 0.99
