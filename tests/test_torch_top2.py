"""Row-wise top-2 (kernel K6's contract): the port's plain version against
the JAX package's ``top2_rows_ref`` and its Pallas kernel in interpret
mode, on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ghicp_tpu.ops.top2 import top2_rows_pallas, top2_rows_ref
from ghicp_tpu_torch.ops import LAUNCHES
from ghicp_tpu_torch.ops.top2 import NEG, top2_rows, top2_rows_plain

torch.set_num_threads(1)
S, C = 512, 1024
MASKED = 11       # a row of masked pairs only


def _inputs(dtype, seed=0):
    """(b, p) as numpy float32 (b already rounded to ``dtype``): the JAX
    test's planted tie at row 7 (columns 100 and 900) and one all-masked
    row of -3e38 benefits."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(S, C)).astype(np.float32) * 10
    b[7, 100] = b[7, 900] = b[7].max() + 5
    b[MASKED] = NEG
    p = rng.normal(size=(C,)).astype(np.float32)
    p[100] = p[900] = 0.0
    b = np.array(jnp.asarray(b).astype(dtype).astype(jnp.float32))
    return b, p


def _torch_b(b, dtype):
    return torch.from_numpy(b).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_reference(dtype):
    b, p = _inputs(dtype)
    v1r, j1r, v2r = (np.asarray(x) for x in top2_rows_ref(
        jnp.asarray(b).astype(dtype), jnp.asarray(p)))
    v1, j1, v2 = top2_rows_plain(_torch_b(b, dtype)[None],
                                 torch.from_numpy(p)[None])
    np.testing.assert_array_equal(j1[0].numpy(), j1r)
    np.testing.assert_array_equal(v1[0].numpy(), v1r)
    np.testing.assert_array_equal(v2[0].numpy(), v2r)
    assert int(j1[0, 7]) == 100 and float(v2[0, 7]) == float(v1[0, 7])
    assert j1.dtype == torch.int32


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_interpret(dtype):
    b, p = _inputs(dtype)
    with pltpu.force_tpu_interpret_mode():
        v1k, j1k, v2k = (np.asarray(x) for x in top2_rows_pallas(
            jnp.asarray(b).astype(dtype), jnp.asarray(p)))
    v1, j1, v2 = (x[0].numpy() for x in top2_rows_plain(
        _torch_b(b, dtype)[None], torch.from_numpy(p)[None]))
    np.testing.assert_array_equal(j1, j1k)
    np.testing.assert_array_equal(v2, v2k)
    rest = np.arange(S) != MASKED
    np.testing.assert_array_equal(v1[rest], v1k[rest])
    # the TPU kernel starts its running maximum at -3e38, so it floors v1
    # there; bf16 rounds -3e38 to -3.004e38, below that floor (the
    # auction sends such a row to the sink either way)
    assert v1k[MASKED] == np.float32(NEG)
    if dtype == jnp.float32:
        assert v1[MASKED] == np.float32(NEG)
    else:
        assert v1[MASKED] == b[MASKED, 0] < np.float32(NEG)


def test_batched_equals_per_pair():
    rng = np.random.default_rng(4)
    P, R, Cb = 3, 96, 200
    b = torch.from_numpy(rng.integers(-20, 20, (P, R, Cb)).astype(
        np.float32)).to(torch.bfloat16)      # integer values: many ties
    p = torch.from_numpy(rng.integers(0, 3, (P, Cb)).astype(np.float32))
    batched = top2_rows(b, p)
    for k in range(P):
        single = top2_rows_plain(b[k:k + 1], p[k:k + 1])
        for x, y in zip(batched, single):
            assert torch.equal(x[k], y[0])


def test_cpu_tensors_take_the_plain_version():
    b, p = _inputs(jnp.float32)
    before = LAUNCHES["top2_rows"]
    out = top2_rows(torch.from_numpy(b)[None], torch.from_numpy(p)[None])
    ref = top2_rows_plain(torch.from_numpy(b)[None],
                          torch.from_numpy(p)[None])
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    assert LAUNCHES["top2_rows"] == before
    with pytest.raises(ValueError):
        top2_rows(torch.from_numpy(b), torch.from_numpy(p))
