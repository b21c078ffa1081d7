"""Tasks for :mod:`ghicp_tpu_torch.shard.launch`: each runs on every rank
as ``task(comm, **payload)`` and returns plain Python and numpy values
(the engine's result, the kernel launches and the collectives' counts of
this rank, and its wall seconds).  Inputs are numpy arrays or CPU tensors;
``device`` None runs each rank on its card (``spmd.rank_device``)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ghicp_tpu_torch.core.comm import rows_of
from ghicp_tpu_torch.ops import LAUNCHES, reset_launches


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _sync(device) -> None:
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(comm, device, fn, warmup=None):
    """(fn(), {launches, collectives, wall}) with the launch counts and the
    collectives' counters zeroed just before; ``warmup()`` (untimed, not
    counted) first where given."""
    if warmup is not None:
        warmup()
    reset_launches()
    comm.reset_stats()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    wall = time.perf_counter() - t0
    return out, dict(launches={k: v for k, v in LAUNCHES.items() if v},
                     collectives=comm.stats(), wall=wall,
                     rank=comm.axis_index(), size=comm.axis_size())


def _engine(res) -> dict:
    n = int(res.iterations)
    m = res.metrics
    return dict(transform=_np(res.transform), iterations=n,
                converged=bool(res.converged), success=bool(res.success),
                final_rmse=float(res.final_rmse), cor=_np(m.cor[:n]),
                rmse=_np(m.rmse[:n]), matches=_np(res.matches))


def _stream(stream):
    """Streaming factors from a payload: BSC factors given as their packed
    words and popcounts (a dict of ``words_s``, ``words_t``, ``na``,
    ``nb``: the bit rows are unpacked here), or the factors themselves."""
    if not isinstance(stream, dict):
        return stream
    from ghicp_tpu_torch.ops.stream_kernel import stream_features
    t = {k: torch.as_tensor(v) for k, v in stream.items()}
    return stream_features(t["words_s"], t["words_t"], t["na"], t["nb"])


class _HammingFD:
    """Pair i's BSC feature distance, made on ``device`` when the engine
    asks for it (``min_hamming_fd`` of the pair's packed bits): each rank
    computes only its pairs', and no [S, T] matrix crosses processes."""

    def __init__(self, packed_s, packed_t, n_bits: int, device):
        self.s, self.t, self.n_bits = packed_s, packed_t, n_bits
        self.device = device

    def __getitem__(self, i):
        from ghicp_tpu_torch.features.hamming import min_hamming_fd
        to = lambda x: torch.as_tensor(x).to(self.device)
        return min_hamming_fd(to(self.s[i]), to(self.t[i])[:1], self.n_bits)


def comm_selftest(comm, values=None, device="cpu"):
    """Each collective on this rank's ``values[rank]``."""
    x = torch.as_tensor(values[comm.axis_index()]).to(device)
    out = dict(psum=comm.psum(x), pmax=comm.pmax(x), pmin=comm.pmin(x),
               ppermute=comm.ppermute(x), ppermute2=comm.ppermute(x, 2),
               all_gather=comm.all_gather(x), rank=comm.axis_index(),
               size=comm.axis_size(), distributed=comm.distributed,
               stats=comm.stats())
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


def sharded(comm, inputs, config, stream=None, init_transform=None,
            it_shift=0.0, device=None, warmup=False):
    """``ghicp_register_sharded`` on the global ``inputs`` (kp_s, mask_s,
    kp_t, mask_t, fd, bbx); ``warmup``: one iteration first, untimed (the
    process's first kernel loads and allocations)."""
    from ghicp_tpu_torch.shard.spmd import ghicp_register_sharded
    d = inputs
    stream = _stream(stream)

    def run(c):
        return ghicp_register_sharded(
            d["kp_s"], d["mask_s"], d["kp_t"], d["mask_t"], d.get("fd"),
            d["bbx"], c, comm, stream=stream, init_transform=init_transform,
            it_shift=it_shift, device=device)
    one = dataclasses.replace(config, max_iterations=1)
    res, info = _timed(comm, device, lambda: run(config),
                       (lambda: run(one)) if warmup else None)
    return {**_engine(res), **info}


def ring(comm, inputs, stream, config, init_transform=None, it_shift=0.0,
         device=None):
    """``ghicp_register_ring`` on the global ``inputs`` and factors."""
    from ghicp_tpu_torch.shard.spmd import ghicp_register_ring
    d = inputs
    res, info = _timed(comm, device, lambda: ghicp_register_ring(
        d["kp_s"], d["mask_s"], d["kp_t"], d["mask_t"], _stream(stream),
        d["bbx"], config, comm, init_transform=init_transform,
        it_shift=it_shift,
        device=device))
    return {**_engine(res), **info}


def batched_sharded(comm, inputs, config, init_transform=None, it_shift=0.0,
                    device=None):
    """``ghicp_register_batched_sharded`` on pairs with a leading axis;
    ``inputs`` holds ``fd`` [P, S, T], or the pairs' packed BSC bits
    (``packed_s`` [P, V, S, W], ``packed_t`` [P, V', T, W], ``n_bits``)
    from which each rank makes its pairs' FD."""
    from ghicp_tpu_torch.registration.ghicp import \
        ghicp_register_batched_sharded
    from ghicp_tpu_torch.shard.spmd import rank_device
    d = inputs
    fd = d.get("fd")
    if fd is None:
        fd = _HammingFD(d["packed_s"], d["packed_t"], d["n_bits"],
                        rank_device() if device is None else device)
    res, info = _timed(comm, device, lambda: ghicp_register_batched_sharded(
        d["kp_s"], d["mask_s"], d["kp_t"], d["mask_t"], fd, d["bbx"],
        config, comm, init_transform=init_transform, it_shift=it_shift,
        device=device))
    return dict(transform=_np(res.transform),
                iterations=_np(res.iterations), matches=_np(res.matches),
                final_rmse=_np(res.final_rmse), **info)


def graph(comm, clouds, pairs, config, keypoint_capacity=None, device=None):
    """``register_graph_distributed``."""
    from ghicp_tpu_torch.shard.multihost import register_graph_distributed
    (tfs, quals, poses), info = _timed(
        comm, device, lambda: register_graph_distributed(
            clouds, pairs, config, keypoint_capacity, comm, device))
    return dict(transforms=tfs, qualities=quals, poses=np.stack(poses),
                **info)


def auction(comm, cd, penalty, eps_final=0.01, max_rounds=8000,
            device="cpu"):
    """The sharded ``auction_match`` on this rank's rows of ``cd``;
    returns the gathered (tgt_idx, w)."""
    from ghicp_tpu_torch.matching.auction import auction_match
    S, T = cd.shape
    rows = rows_of(comm, S)
    c = torch.as_tensor(cd[rows]).to(device)
    ones = lambda n: torch.ones((n,), dtype=torch.bool, device=device)
    res = auction_match(c, penalty, ones(c.shape[0]), ones(T),
                        eps_final=eps_final, max_rounds=max_rounds,
                        comm=comm, total_rows=S)
    return dict(tgt_idx=_np(comm.all_gather(res.match.tgt_idx)),
                w=_np(comm.all_gather(res.match.w)),
                n_matches=float(res.match.n_matches))


def _ms(fn, device, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up
    (CUDA events on the card, the host clock on the CPU)."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def ring_sweep_check(comm, kp_s, kp_t, mask_s, mask_t, feats, prices, acol,
                     wed, wfd, scale, subset=None, reps=0, device=None):
    """``ring_sweep`` alone on this rank's rows against one
    ``stream_sweep`` over the whole target (K5 on the card, its plain
    version on the CPU), on all the rank's rows and, with ``subset`` (local
    row ids), on those rows (the compact form); with ``reps``, the times of
    one step's K5 call and its plain version (on rank 0 alone, the others
    waiting) and of one rotation of the block (every rank passing its
    block at once, as a ring step does).  Returns the comparisons
    (``equal``: v1, j1, v2, j2, vsel bit-equal and the counts equal;
    ``sums_rel``: the sums' relative difference; ``abs_err``: the largest
    difference of v1, v2 and vsel)."""
    from ghicp_tpu_torch.ops.stream_kernel import (ring_features, ring_sweep,
                                                   ring_target,
                                                   stream_sweep,
                                                   stream_sweep_plain,
                                                   subset_rows, sweep_target)
    from ghicp_tpu_torch.shard.spmd import rank_device
    dev = rank_device() if device is None else torch.device(device)
    to = lambda x: torch.as_tensor(x).to(dev)
    kp_s, kp_t, mask_s, mask_t, prices, acol = (to(x) for x in (
        kp_s, kp_t, mask_s, mask_t, prices, acol))
    feats = _stream(feats)
    feats = type(feats)(*(to(x) for x in feats))
    n, r = comm.axis_size(), comm.axis_index()
    rows = rows_of(comm, kp_s.shape[0])
    ring = ring_features(feats, rows, r, n)
    mine = subset_rows(feats, rows)
    ks, ms, ac = kp_s[rows], mask_s[rows], acol[rows]
    cuda = dev.type == "cuda"
    rt = ring_target(kp_t, ring, mask_t) if cuda else None
    tg = sweep_target(kp_t, mine, mask_t) if cuda else None
    w = (wed, wfd, scale)

    def compare(a, b) -> dict:
        eq = all(torch.equal(getattr(a, f), getattr(b, f))
                 for f in ("v1", "j1", "v2", "j2", "vsel"))
        rel = max(float(abs(getattr(a, f) - getattr(b, f))
                        / max(abs(float(getattr(b, f))), 1e-30))
                  for f in ("cd_sum", "cd_sumsq"))
        maxes = all(torch.equal(getattr(a, f), getattr(b, f))
                    for f in ("cd_max", "ed_max", "b_max", "fd_max"))
        err = max(float((getattr(a, f) - getattr(b, f)).abs().max())
                  for f in ("v1", "v2", "vsel"))
        return dict(equal=bool(eq and torch.equal(a.cnt, b.cnt)),
                    maxes_equal=bool(maxes), sums_rel=rel, abs_err=err,
                    cnt=float(a.cnt))

    reset_launches()
    comm.reset_stats()
    got = ring_sweep(ks, kp_t, ring, ms, mask_t, prices, ac, *w, comm,
                     target=rt)
    info = dict(launches={k: v for k, v in LAUNCHES.items() if v},
                collectives=comm.stats())
    out = dict(full=compare(got, stream_sweep(ks, kp_t, mine, ms, mask_t,
                                              prices, ac, *w, target=tg)),
               rows=int(ks.shape[0]), **info)
    if subset is not None:
        idx = to(subset)
        sub_mask = ms[idx]
        got = ring_sweep(ks[idx], kp_t, subset_rows(ring, idx), sub_mask,
                         mask_t, prices, ac[idx], *w, comm, target=rt)
        out["compact"] = compare(got, stream_sweep(
            ks[idx], kp_t, subset_rows(mine, idx), sub_mask, mask_t, prices,
            ac[idx], *w, target=tg))
    if reps:
        c = ring.bits_blk.shape[0]
        from ghicp_tpu_torch.ops.stream_kernel import _ring_step
        args, step_tg = _ring_step(ks, kp_t, ring, ms, mask_t, prices, ac,
                                   ring.bits_blk, r * c, rt)
        if r == 0:
            out["step_ms"] = _ms(
                lambda: stream_sweep(*args, *w, target=step_tg), dev, reps)
            out["step_plain_ms"] = _ms(
                lambda: stream_sweep_plain(*args, *w), dev, max(1, reps // 5))
            out["step_pairs"] = float(ms.sum()) * float(
                mask_t[r * c:(r + 1) * c].sum())
            out["variants"] = int(ring.words_s.shape[0])
        comm.psum(torch.zeros((), device=dev))   # the others wait here
        comm.reset_stats()
        out["rotation_ms"] = _ms(lambda: comm.ppermute(ring.bits_blk), dev,
                                 reps)
        out["block_bytes"] = int(ring.bits_blk.numel())
        out["step_shape"] = (int(ks.shape[0]), c)
    return out


def many(comm, jobs):
    """Several tasks in one launch: ``jobs`` a list of (task name,
    keyword arguments); returns their results in order."""
    return [TASKS[name](comm, **kw) for name, kw in jobs]


TASKS = {"comm_selftest": comm_selftest, "sharded": sharded, "ring": ring,
         "batched_sharded": batched_sharded, "graph": graph,
         "auction": auction, "ring_sweep_check": ring_sweep_check,
         "many": many}
