"""A CPU model of K1's walk on the card (csrc/cost.cu ``cost_kernel``)
held against the plain version and the JAX kernel in interpret mode, in
its four forms (bf16 and float32 FD, the BSC and the multiplicative
blend).

The model: blocks walk bands of 64 rows (band k on block k mod the grid,
blocks in a shuffled order), a warp 4 rows; a lane owns 8 columns of each
256-column pass of each 1024-column chunk (lanes past the last column
skip).  A lane's sums of CD and CD^2 are float32 over a chunk, in its
order (pass, half, row, column), folded into double at the chunk's end
and across its bands; a warp's lanes are reduced by a butterfly and the
warps' sums reach the global accumulators in a shuffled order.  The
count is an integer; the maxima, v1 and vsel are maxima, merged in a
shuffled order.  b, v1, vsel, the count and the maxima are held bit-equal
to the plain version, the sums within rtol 1e-4 (their order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.ops.cost_kernel import fused_benefit as jax_fused_benefit
from ghicp_tpu_torch.ops.cost_kernel import (NEG, _factors, factor_cost,
                                             fused_benefit_plain)

torch.set_num_threads(1)

F32 = np.float32
BAND, RPW, WARPS, CHUNK, PASS = 64, 4, 16, 1024, 256


def _fixture(seed=3, S=256, C=1152):
    """A centred pair with a real/-1/sink assignment; C = a chunk and a
    half pass (the last pass's lanes 16-31 skip)."""
    rng = np.random.default_rng(seed)
    kp_s = rng.uniform(-6, 6, (S, 3)).astype(F32)
    kp_t = rng.uniform(-6, 6, (C, 3)).astype(F32)
    fd = rng.integers(0, 441, (S, C)).astype(F32)
    ms = np.ones(S, bool)
    ms[-13:] = False
    mt = np.ones(C, bool)
    mt[-7:] = False
    p = rng.uniform(0, 3, C).astype(F32)
    acol0 = rng.integers(0, C, S).astype(np.int64)
    acol0[::7] = -1
    acol0[::11] = 2**30
    return kp_s, kp_t, fd, ms, mt, p, acol0


def _lane_order(cb, width):
    """[32 lanes, terms] (row in the warp, column) of a lane's entries in a
    chunk, in the kernel's order; -1 columns are skipped lanes' slots."""
    rows, cols = [], []
    for lane in range(32):
        r_l, c_l = [], []
        for ps in range(0, width, PASS):
            c0 = cb + ps + lane * 8
            for h in range(2):
                for r in range(RPW):
                    for q in range(4):
                        r_l.append(r)
                        c_l.append(c0 + h * 4 + q if c0 < cb + width else -1)
        rows.append(r_l)
        cols.append(c_l)
    return np.array(rows), np.array(cols)


def _butterfly(x):
    """A warp's xor-shuffle sum over its lanes (last axis), in double."""
    x = x.copy()
    lanes = np.arange(32)
    for s in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ s]
    return x[..., 0]


def _model(ks, kt, fd, ms, mt, wed, wfd, scale, p, acol0, stats, mult,
           nblocks, rng):
    S, C = fd.shape
    ed, cd = factor_cost(_factors(ks), _factors(kt), fd, wed, wfd, scale,
                         mult)
    ed, cd = ed.numpy(), cd.numpy()
    m = ms.numpy()[:, None] & mt.numpy()[None, :]
    bt = np.where(m, -cd, F32(NEG)).astype(F32)
    v = (bt - p.numpy()[None, :]).astype(F32)
    nb = -(-S // BAND)
    pad = nb * BAND - S
    cdz = np.pad(np.where(m, cd, F32(0.0)), ((0, pad), (0, 0))).astype(F32)
    acc = np.zeros((nblocks, WARPS, 32, 2))
    for band in range(nb):
        blk = band % nblocks
        x = cdz[band * BAND:(band + 1) * BAND].reshape(WARPS, RPW, C)
        for cb in range(0, C, CHUNK):
            r, c = _lane_order(cb, min(CHUNK, C - cb))
            t = np.where(c >= 0, x[:, r, np.maximum(c, 0)], F32(0.0))
            f1 = np.cumsum(t, axis=-1, dtype=F32)[..., -1]
            f2 = np.cumsum((t * t).astype(F32), axis=-1, dtype=F32)[..., -1]
            acc[blk, :, :, 0] += f1.astype(np.float64)
            acc[blk, :, :, 1] += f2.astype(np.float64)
    warp_sums = _butterfly(acc.transpose(0, 1, 3, 2)).reshape(-1, 2)
    s = np.zeros(2)
    for k in rng.permutation(len(warp_sums)):
        s = s + warp_sums[k]
    # maxima: a lane's, then the warps' and blocks' in a shuffled order
    def shuffled_max(vals, floor):
        out = F32(floor)
        for k in rng.permutation(len(vals)):
            out = max(out, F32(vals[k]))
        return out
    edmax = shuffled_max(np.where(m, ed, 0.0).max(axis=1), 0.0)
    bmax = shuffled_max(np.where(m, bt, F32(NEG)).max(axis=1), NEG)
    zero = F32(0.0)
    if stats:
        cnt, s1, s2 = F32(int(m.sum())), F32(s[0]), F32(s[1])
        cdmax = shuffled_max(np.where(m, cd, 0.0).max(axis=1), 0.0)
    else:
        cnt = s1 = s2 = cdmax = zero
    v1 = np.full(S, -np.inf, F32)
    vsel = np.full(S, F32(NEG), F32)
    a = acol0.numpy()
    real = (a >= 0) & (a < C)
    hit = np.zeros((S, C), bool)
    hit[np.nonzero(real)[0], a[real]] = True
    for lane in rng.permutation(32):
        cols = (np.arange(0, C, PASS)[:, None] + lane * 8
                + np.arange(8)).ravel()
        cols = cols[cols < C]
        v1 = np.maximum(v1, v[:, cols].max(axis=1))
        vsel = np.maximum(vsel, np.where(hit[:, cols], v[:, cols],
                                         F32(NEG)).max(axis=1))
    b = torch.from_numpy(bt).to(fd.dtype)
    return (b, cnt, s1, s2, cdmax, edmax, bmax, v1, vsel)


FORMS = [("bf16", False), ("f32", False), ("bf16", True), ("f32", True)]


@pytest.mark.parametrize("nblocks", [132, 3])
@pytest.mark.parametrize("dtype,mult", FORMS)
@pytest.mark.parametrize("stats", [True, False])
def test_k1_band_model_matches_plain(dtype, mult, stats, nblocks):
    ks, kt, fd, ms, mt, p, acol0 = _fixture()
    if mult:
        fd = fd / 441.0
        fd[::5, ::3] = 0.0
    T = torch.from_numpy
    fdt = T(fd).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    w = (1.0, 1.0 / 3.0, 0.22) if mult else (0.7, 0.3, 0.22)
    args = (T(ks), T(kt), fdt, T(ms), T(mt), *w, T(p), T(acol0))
    want = fused_benefit_plain(*args, stats, mult)
    got = _model(*args, stats, mult, nblocks, np.random.default_rng(nblocks))
    ib = torch.int16 if dtype == "bf16" else torch.int32
    assert torch.equal(got[0].view(ib), want[0].view(ib))
    for i in (1, 4, 5, 6):
        assert got[i] == float(want[i]), i
    for i in (7, 8):
        assert np.array_equal(got[i].view(np.int32),
                              want[i].numpy().view(np.int32)), i
    for i in (2, 3):
        assert got[i] == pytest.approx(float(want[i]), rel=1e-4, abs=1e-6)
    if stats:
        assert float(want[1]) == (ms[:, None] & mt[None, :]).sum()


@pytest.mark.parametrize("dtype,mult", FORMS)
def test_k1_band_model_matches_jax_kernel(dtype, mult):
    """The model against the JAX package's K1 in interpret mode, with the
    tolerances of tests/test_torch_cost_kernel.py (the JAX kernel takes
    another bf16 rounding path and, for the blend, its own exp / log)."""
    ks, kt, fd, ms, mt, p, acol0 = _fixture(seed=4, S=256, C=1152)
    acol0 = acol0.astype(np.int32)
    if mult:
        fd = fd / 441.0
        fd[::5, ::3] = 0.0
    w = (1.0, 1.0 / 3.0, 0.22) if mult else (0.7, 0.3, 0.22)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jfd = jnp.asarray(fd).astype(jdt)
    jk = jax_fused_benefit(jnp.asarray(ks), jnp.asarray(kt), jfd,
                           jnp.asarray(ms), jnp.asarray(mt), *w, ts=128,
                           interpret=True, out_dtype=jdt,
                           p_defl=jnp.asarray(p), acol0=jnp.asarray(acol0),
                           mult_blend=mult)
    T = torch.from_numpy
    fdt = T(np.array(jfd.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = _model(T(ks), T(kt), fdt, T(ms), T(mt), *w, T(p), T(acol0), True,
                 mult, 132, np.random.default_rng(0))
    b = got[0].to(torch.float32).numpy()
    bj = np.array(jk[0].astype(jnp.float32))
    if mult:
        np.testing.assert_allclose(b, bj, rtol=1e-2, atol=1e-2)
    elif dtype == "bf16":
        mine = np.asarray(got[0].view(torch.int16), np.int32)
        theirs = np.asarray(T(bj).to(torch.bfloat16).view(torch.int16),
                            np.int32)
        ulp = np.abs(mine - theirs)
        assert ulp.max() <= 1 and np.mean(ulp > 0) <= 1e-3
    else:
        np.testing.assert_allclose(b, bj, rtol=1e-5, atol=1e-5)
    assert got[1] == float(jk[1])
    for i in range(2, 6):
        np.testing.assert_allclose(float(got[i]), float(jk[i]), rtol=1e-4)
    np.testing.assert_allclose(float(got[6]), float(jk[6]), atol=1e-4)
    for i in (7, 8):
        np.testing.assert_allclose(got[i], np.asarray(jk[i]), rtol=1e-5,
                                   atol=1e-5)
