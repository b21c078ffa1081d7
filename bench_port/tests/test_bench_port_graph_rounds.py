"""The streaming solve's guarded rounds in the cell ``tls_scan.stream``:
the reader of ``graph_round_share.stream`` on the CPU, and on the card the
pool's pairs registered with the rounds replayed from CUDA graphs and run
eagerly, which must agree bit for bit (``python -m pytest -o addopts=""
bench_port/tests -m card -k graph`` on the card's machine)."""
import hashlib

import numpy as np
import pytest

import run
from bench_small import ROOT


def _pairs(**counts):
    return [{"launches": dict(c)} for c in counts.values()]


def test_graph_round_share_reader():
    read = run.reader("graph_round_share.stream")
    rec = {"pairs": _pairs(
        a={"stream_round_graph": 40, "stream_round_eager": 10,
           "stream_round_idle": 3, "stream_sweep": 53},
        b={"stream_round_graph": 50, "stream_round_eager": 0})}
    assert read(rec) == 0.9
    # a program that counts no rounds (before the guarded rounds), or a
    # cell with no streaming solve
    assert read({"pairs": _pairs(a={"stream_sweep": 9})}) is None
    assert read({"pairs": []}) is None


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.card
def test_graph_rounds_equal_eager_rounds_on_the_pool(card, monkeypatch):
    """Each of the pool's pairs: the same transform, matches, iterations
    and, solve by solve, the same assignment, prices, rounds and epsilon
    with the guarded rounds replayed from a graph as run eagerly, and the
    same K5 launch counts; one capture a solve that reached a compacted
    round, and most rounds replayed."""
    import torch
    from ghicp_tpu_torch.matching import stream_auction as sa
    from ghicp_tpu_torch.ops import LAUNCHES, _build
    from ghicp_tpu_torch.registration import ghicp, pipeline

    spec = run.cell_spec(ROOT, "tls_scan.stream")
    cfg = run.engine_config(spec)
    pool = run.gen.make_pool(spec["config"]["scene"],
                             spec["traffic"]["scene_seeds"])
    _build.build_all()
    solve = ghicp.stream_solve
    solves = []

    def recorded(*a, **kw):
        res = solve(*a, **kw)
        solves.append(_digest(
            res.acol.cpu().numpy(), res.prices.cpu().numpy(),
            res.eps_used.cpu().numpy(),
            np.int64([res.rounds, res.compact_sweeps])))
        return res
    monkeypatch.setattr(ghicp, "stream_solve", recorded)
    handovers, graph_path = [], sa._graph_device

    def eager(dev):
        handovers.append(dev)
        return False

    def register(k, graph: bool):
        monkeypatch.setattr(sa, "_graph_device",
                            graph_path if graph else eager)
        solves.clear()
        before = dict(LAUNCHES)
        out = pipeline.register_pair(pool[k][1], pool[k][2], cfg,
                                     device="cuda")
        torch.cuda.synchronize()
        return (_digest(np.asarray(out.transform),
                        out.result.matches.cpu().numpy()),
                int(out.result.iterations), list(solves),
                run.launches_since(before, LAUNCHES))

    rounds = {"stream_round_graph": 0, "stream_round_eager": 0}
    for k in range(len(pool)):
        n0 = len(handovers)
        want = register(k, graph=False)
        got = register(k, graph=True)
        assert got[:3] == want[:3], pool[k][0]
        # each replay counts its K5 launch as the eager round does
        k5 = lambda n: {x: v for x, v in n.items()
                        if x.startswith("stream_sweep")}
        assert k5(got[3]) == k5(want[3])
        assert got[3].get("stream_graph_capture", 0) == len(handovers) - n0
        for name in rounds:
            rounds[name] += got[3].get(name, 0)
    assert rounds["stream_round_graph"] >= 0.9 * sum(rounds.values())
