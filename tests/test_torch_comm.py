"""The port's collectives (``ghicp_tpu_torch.core.comm``) and its launcher
(``shard/launch.py``) on the CPU: psum / pmax / pmin / ppermute /
all_gather at 2 and 4 gloo ranks against numpy, ``LOCAL`` as the
identity, ``init_distributed`` without an environment, NCCL refused
without a card (never turned into gloo), and a failed or hung rank failing
the launch."""
import sys

import numpy as np
import pytest
import torch

from ghicp_tpu_torch.core.comm import LOCAL, Comm, check_nccl, rows_of
from ghicp_tpu_torch.shard import init_distributed
from ghicp_tpu_torch.shard.launch import launch, launch_command

torch.set_num_threads(1)
RANKS = (2, 4)


def _values(P):
    rng = np.random.default_rng(P)
    return [rng.normal(size=(5,)).astype(np.float32) for _ in range(P)]


@pytest.fixture(scope="module")
def runs():
    return {P: launch("comm_selftest", P, "gloo",
                      dict(values=_values(P), device="cpu"))
            for P in RANKS}


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("op", ["psum", "pmax", "pmin"])
def test_reductions_against_numpy(runs, P, op):
    x = np.stack(_values(P))
    want = {"psum": x.sum(0), "pmax": x.max(0), "pmin": x.min(0)}[op]
    for r, res in enumerate(runs[P]):
        assert res["rank"] == r and res["size"] == P and res["distributed"]
        np.testing.assert_allclose(res[op], want, rtol=1e-6)
        if op != "psum":
            np.testing.assert_array_equal(res[op], want)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("shift", [1, 2])
def test_ppermute_takes_from_the_next_rank(runs, P, shift):
    """Rank r receives rank r + shift's tensor (the JAX ring's
    ``perm = [(i, i - 1)]``)."""
    x = _values(P)
    key = "ppermute" if shift == 1 else "ppermute2"
    for r, res in enumerate(runs[P]):
        np.testing.assert_array_equal(res[key], x[(r + shift) % P])


@pytest.mark.parametrize("P", RANKS)
def test_all_gather_in_rank_order_and_counted(runs, P):
    x = np.concatenate(_values(P))
    for res in runs[P]:
        np.testing.assert_array_equal(res["all_gather"], x)
        calls, nbytes, secs = res["stats"]["all"]
        # five collectives and the shift-2 ring step (at 2 ranks its own
        # rank: no transfer)
        assert calls == (6 if P > 2 else 5) and nbytes > 0 and secs > 0


def test_local_is_the_identity():
    x = torch.arange(6.0)
    for op in (LOCAL.psum, LOCAL.pmax, LOCAL.pmin, LOCAL.ppermute,
               LOCAL.all_gather):
        assert op(x) is x
    assert (LOCAL.axis_index(), LOCAL.axis_size()) == (0, 1)
    assert not LOCAL.distributed and LOCAL.stats()["all"] == (0, 0, 0.0)
    assert rows_of(LOCAL, 10) == slice(0, 10)


def test_rows_of_raises_on_indivisible_counts():
    c = Comm.__new__(Comm)
    c.rank, c.size = 1, 4
    assert rows_of(c, 12) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        rows_of(c, 10)


def test_init_distributed_is_a_noop_without_the_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 1
    assert not torch.distributed.is_initialized()


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_nccl(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("tcp://127.0.0.1:9", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_cpu_tensors_and_extra_ranks(monkeypatch):
    c = Comm.__new__(Comm)
    c.backend, c.rank, c.size = "nccl", 0, 2
    c.counts = LOCAL.counts
    with pytest.raises(ValueError, match="CUDA tensors only"):
        c.psum(torch.ones(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks on this host"):
        check_nccl(2)


def test_a_nccl_launch_fails_here_and_does_not_turn_into_gloo():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch("comm_selftest", 2, "nccl", dict(values=_values(2)),
               timeout=120)


def test_a_failed_rank_fails_the_launch_with_its_output():
    code = ("import os, sys\n"
            "if os.environ['RANK'] == '1':\n"
            "    print('rank one gives up'); sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited 3"
                       "(.|\\n)*rank one gives up"):
        launch_command([sys.executable, "-c", code], 2, timeout=60)


def test_a_hung_rank_fails_the_launch_at_its_timeout():
    code = ("import os, time\n"
            "if os.environ['RANK'] == '0':\n"
            "    time.sleep(60)\n")
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\] of 2 still"):
        launch_command([sys.executable, "-c", code], 2, timeout=3)
