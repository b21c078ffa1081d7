"""The NN and reciprocal-NN matchers and the feature-"none" blend against
the JAX package's ``matching/matchers.py`` and ``matching/cost.py`` on the
same cost matrices: masked rows and columns (+inf), planted row and column
ties, one column with no valid row; a single pair and a pair axis."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.matching.cost import blend_none as jax_blend_none
from ghicp_tpu.matching.matchers import nn_match as jax_nn
from ghicp_tpu.matching.matchers import nnr_match as jax_nnr
from ghicp_tpu_torch.matching.cost import blend_none
from ghicp_tpu_torch.matching.matchers import nn_match, nnr_match

torch.set_num_threads(1)
S, T = 96, 80


def _costs(seed):
    """A cost matrix with +inf at masked pairs, exact ties in rows and in
    columns, and column 5 without a valid row."""
    rng = np.random.default_rng(seed)
    cd = rng.integers(0, 40, (S, T)).astype(np.float32) * 0.25
    ms = rng.random(S) < 0.85
    mt = rng.random(T) < 0.9
    mt[5] = True
    # row ties: a row minimum at two columns
    for i in range(0, S, 7):
        a, b = rng.choice(T, 2, replace=False)
        cd[i, a] = cd[i, b] = -1.0
    # column ties: a column minimum at two rows
    for j in range(1, T, 9):
        a, b = rng.choice(S, 2, replace=False)
        cd[a, j] = cd[b, j] = -2.0
    cd[:, 5] = np.inf
    cd = np.where(ms[:, None] & mt[None, :], cd, np.inf).astype(np.float32)
    return cd, ms, mt


@pytest.mark.parametrize("pairs", [1, 3])
def test_nn_and_nnr_match_jax(pairs):
    probs = [_costs(seed) for seed in range(pairs)]
    pens = [float(p) for p in np.linspace(2.0, 6.0, pairs)]
    want = []
    for (cd, ms, mt), pen in zip(probs, pens):
        args = (jnp.asarray(cd), jnp.asarray(ms), jnp.asarray(mt))
        want.append((jax_nn(args[0], jnp.float32(pen), *args[1:]),
                     jax_nnr(*args)))
    stack = lambda k: torch.from_numpy(np.stack([p[k] for p in probs]))
    cd, ms, mt = stack(0), stack(1), stack(2)
    if pairs == 1:
        got = [(nn_match(cd[0], pens[0], ms[0], mt[0]),
                nnr_match(cd[0], ms[0], mt[0]))]
    else:
        nn = nn_match(cd, torch.tensor(pens), ms, mt)
        nnr = nnr_match(cd, ms, mt)
        got = [(type(nn)(*(x[k] for x in nn)), type(nnr)(*(x[k] for x in nnr)))
               for k in range(pairs)]
    for (g_nn, g_nnr), (w_nn, w_nnr) in zip(got, want):
        for g, w in ((g_nn, w_nn), (g_nnr, w_nnr)):
            np.testing.assert_array_equal(g.tgt_idx.numpy(),
                                          np.asarray(w.tgt_idx))
            np.testing.assert_array_equal(g.w.numpy(), np.asarray(w.w))
            assert float(g.n_matches) == float(w.n_matches)
        # reciprocal pairs exist; the column without a valid row matches none
        assert float(g_nnr.n_matches) > 0
        for g in (g_nn, g_nnr):
            assert not bool(((g.tgt_idx == 5) & (g.w > 0)).any())


def test_blend_none_matches_jax():
    rng = np.random.default_rng(3)
    ed = rng.uniform(0.0, 4.0, (S, T)).astype(np.float32)
    ms, mt = rng.random(S) < 0.9, rng.random(T) < 0.8
    want = jax_blend_none(jnp.asarray(ed), jnp.asarray(ms), jnp.asarray(mt))
    got = blend_none(torch.from_numpy(ed), torch.from_numpy(ms),
                     torch.from_numpy(mt))
    np.testing.assert_array_equal(got.cd.numpy(), np.asarray(want.cd))
    for k in ("penalty", "cd_mean", "cd_std"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want, k)), rtol=1e-5)
    # the floor of 1
    low = blend_none(torch.from_numpy(ed * 0.01), torch.from_numpy(ms),
                     torch.from_numpy(mt))
    assert float(low.penalty) == 1.0
