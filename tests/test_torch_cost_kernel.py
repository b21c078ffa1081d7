"""The port's fused benefit sweep (plain version of the K1 kernel) against
the JAX package's Pallas kernel in interpret mode and its jnp reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.ops.cost_kernel import fused_benefit as jax_fused_benefit
from ghicp_tpu.ops.cost_kernel import fused_benefit_ref
from ghicp_tpu_torch.ops.cost_kernel import fused_benefit

torch.set_num_threads(1)


def _fixture(seed=0, S=256, C=384, offset=300.0):
    """The JAX kernel test's fixture, centred like the engine, plus a
    price vector and an assignment mixing real columns, -1 and the sink."""
    rng = np.random.default_rng(seed)
    kp_s = (rng.uniform(0, 12, (S, 3)) + offset).astype(np.float32)
    kp_t = (rng.uniform(0, 12, (C, 3)) + offset).astype(np.float32)
    fd = rng.integers(0, 441, (S, C)).astype(np.float32)
    ms = np.ones(S, bool)
    ms[-13:] = False
    mt = np.ones(C, bool)
    mt[-7:] = False
    mid = 0.5 * (kp_t[mt].min(0) + kp_t[mt].max(0))
    rng = np.random.default_rng(5)
    p = rng.uniform(0, 3, C).astype(np.float32)
    acol0 = rng.integers(0, C, S).astype(np.int32)
    acol0[::7] = -1
    acol0[::11] = 2**30
    return kp_s - mid, kp_t - mid, fd, ms, mt, p, acol0


def _bf16_bits(x):
    return np.asarray(x.view(torch.int16), np.int32)


@pytest.mark.parametrize("with_stats", [True, False])
def test_plain_k1_matches_jax_kernel_and_ref(with_stats):
    ks, kt, fd, ms, mt, p, acol0 = _fixture()
    w = (0.7, 0.3, 0.22)
    fdb = jnp.asarray(fd).astype(jnp.bfloat16)
    jargs = (jnp.asarray(ks), jnp.asarray(kt), fdb, jnp.asarray(ms),
             jnp.asarray(mt)) + w
    jk = jax_fused_benefit(*jargs, ts=128, interpret=True,
                           p_defl=jnp.asarray(p), acol0=jnp.asarray(acol0),
                           with_stats=with_stats)
    jr = fused_benefit_ref(*jargs, p_defl=jnp.asarray(p),
                           acol0=jnp.asarray(acol0))
    T = torch.from_numpy
    got = fused_benefit(T(ks), T(kt), T(fd).to(torch.bfloat16), T(ms), T(mt),
                        *w, p_defl=T(p), acol0=T(acol0),
                        with_stats=with_stats)
    mine = _bf16_bits(got[0])
    for want in (jk, jr):
        theirs = np.asarray(
            torch.tensor(np.asarray(want[0].astype(jnp.float32)))
            .to(torch.bfloat16).view(torch.int16), np.int32)
        ulp = np.abs(mine - theirs)
        assert ulp.max() <= 1 and np.mean(ulp > 0) <= 1e-3
        np.testing.assert_allclose(got[7].numpy(), np.asarray(want[7]),
                                   rtol=1e-5, atol=1e-5)     # v1
        np.testing.assert_allclose(got[8].numpy(), np.asarray(want[8]),
                                   rtol=1e-5, atol=1e-5)     # vsel
        for i in (5, 6):                                     # ed_max, b_max
            np.testing.assert_allclose(float(got[i]), float(want[i]),
                                       rtol=1e-5)
    stats = jk if with_stats else jr
    assert float(got[1]) == (float(stats[1]) if with_stats else 0.0)
    if with_stats:
        for i in (2, 3):                                     # sums
            np.testing.assert_allclose(float(got[i]), float(stats[i]),
                                       rtol=1e-4)
        np.testing.assert_allclose(float(got[4]), float(stats[4]),
                                   rtol=1e-5)                # cd_max


def test_plain_k1_mult_blend_matches_jax_kernel_and_ref():
    """The FPFH/RoPS lane, cd = ed * exp(-k log(max(fd, 1e-6))), on a
    similarity FD with exact zeros (the 1e-6 floor), with the tolerances
    of the JAX package's own kernel-vs-reference test."""
    ks, kt, fd, ms, mt, p, acol0 = _fixture(seed=7)
    sim = fd / 441.0
    sim[::5, ::3] = 0.0
    w = (1.0, 1.0 / 3.0, 0.22)
    simb = jnp.asarray(sim).astype(jnp.bfloat16)
    jargs = (jnp.asarray(ks), jnp.asarray(kt), simb, jnp.asarray(ms),
             jnp.asarray(mt)) + w
    jk = jax_fused_benefit(*jargs, ts=128, interpret=True,
                           p_defl=jnp.asarray(p), acol0=jnp.asarray(acol0),
                           mult_blend=True)
    jr = fused_benefit_ref(*jargs, p_defl=jnp.asarray(p),
                           acol0=jnp.asarray(acol0), mult_blend=True)
    T = torch.from_numpy
    got = fused_benefit(T(ks), T(kt), T(sim).to(torch.bfloat16), T(ms),
                        T(mt), *w, p_defl=T(p), acol0=T(acol0),
                        mult_blend=True)
    b = got[0].to(torch.float32).numpy()
    for want in (jk, jr):
        np.testing.assert_allclose(b, np.asarray(want[0].astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)
        for i in range(1, 6):
            np.testing.assert_allclose(float(got[i]), float(want[i]),
                                       rtol=1e-4)
        # b_max = -(least CD), at the nearest pair: the norm-expansion ED
        # keeps only an absolute accuracy there (scale * ~1e-5 / |ED|),
        # and the cross term is three float32 products here, a dot there
        np.testing.assert_allclose(float(got[6]), float(want[6]), atol=1e-4)
        for i in (7, 8):                                     # v1, vsel
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       rtol=1e-5, atol=1e-5)
