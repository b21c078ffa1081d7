"""Gauss-Seidel auction phase (kernel K2) and the single-launch warm
iteration (kernel K3), CUDA C++ in ``csrc/auction.cu``, with their plain
PyTorch versions.

K2 replaces ``ghicp_tpu/ops/auction_rounds.py::auction_phase_gs_pallas``
(Pallas ``_gs_kernel``); K3 replaces
``ghicp_tpu/ops/auction_rounds.py::auction_warm_fused_pallas`` (Pallas
``_warm_fused_kernel``), with its ``mult_blend`` branch (the FPFH/RoPS cost
ED * exp(-k log(max(FD, 1e-6))) in the benefit tile).  Both are bound by memory on this card: a full
sweep reads the bf16 [S, C] matrix once (134 MB at 8192^2) and later sweeps
only the row tiles with open rows.  The design notes (one cooperative
persistent launch, 64-bit atomicMax bid resolution with the lowest-row tie
rule, the exact sequential tile order) are at the head of the CUDA source.

Semantics of one phase (both versions):
  rows of tile height ``ts`` are visited sweep by sweep over the tiles that
  had open rows when the sweep began; an open row computes (v1, j1, v2) of
  (b - p) (lowest column on ties), exits to the sink when v1 <= sink, else
  bids delta = v1 - max(v2, sink) + eps_r on j1; each column goes to the
  highest delta (lowest row on ties) and its price rises by that delta; the
  evicted owner reopens.  ``rounds`` counts sweeps; the epsilon of sweep r
  is eps * sched[r] with the escalation table of :func:`escalation_schedule`.
"""
from __future__ import annotations

import ctypes

import torch

from ghicp_tpu_torch.ops import as_rows, count_launch, require_device
from ghicp_tpu_torch.ops.cost_kernel import _f32, _factors, factor_cost

NEG = -3.0e38
_BIG = 2**31 - 1
MAX_TILES = 1024


def gs_tile_rows(C: int) -> int:
    """Row-tile height of the GS phase (the JAX package's ``_gs_ts``)."""
    ts = 256
    while ts > 16 and ts * C > 256 * 8192:
        ts //= 2
    return ts


def escalation_schedule(max_rounds: int, esc_after: int,
                        esc_period: int) -> torch.Tensor:
    """[max(max_rounds, 1)] float32 epsilon boosts: 2^((r - esc_after) /
    esc_period) once r passes ``esc_after`` (0 = no escalation).  Computed
    on the host so the kernel and the plain version read the same values."""
    n = max(int(max_rounds), 1)
    if esc_after <= 0:
        return torch.ones((n,), dtype=torch.float32)
    r = torch.arange(n, dtype=torch.int64)
    x = torch.clamp(r - int(esc_after), min=0).to(torch.float32)
    return torch.exp2(x / float(max(int(esc_period), 1)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tile_bid_resolve(rows_b, sl, gid, p, owner, sunk, open_, eps_r, sink):
    """One Gauss-Seidel bid/resolve batch for one row tile (in place)."""
    S = open_.shape[0]
    C = p.shape[0]
    op = open_[sl] > 0
    v = rows_b.to(torch.float32) - p[None, :]
    j1 = torch.argmax(v, dim=1)
    v1 = v.gather(1, j1[:, None])[:, 0]
    cols = torch.arange(C, device=p.device)
    v2 = torch.where(cols[None, :] == j1[:, None], NEG, v).amax(dim=1)
    to_sink = op & (v1 <= sink)
    bidding = op & ~to_sink
    delta = (v1 - torch.clamp(v2, min=sink)) + eps_r
    ninf = torch.full((C,), float("-inf"), dtype=torch.float32,
                      device=p.device)
    dmax = ninf.scatter_reduce(0, j1, torch.where(bidding, delta, -torch.inf),
                               "amax")
    is_best = bidding & (delta == dmax[j1])
    big = torch.full((C,), _BIG, dtype=torch.int64, device=p.device)
    win = big.scatter_reduce(0, j1, torch.where(is_best, gid, _BIG), "amin")
    has = win < _BIG
    won = bidding & (win[j1] == gid)
    vic = torch.where(won, owner[j1].to(torch.int64), -1)
    owner.copy_(torch.where(has, win, owner.to(torch.int64)).to(owner.dtype))
    p.copy_(p + torch.where(has, dmax, 0.0))
    sunk[sl] = torch.where(to_sink, 1, sunk[sl])
    open_[sl] = torch.where(to_sink, 0, open_[sl])
    ext = torch.cat([open_, open_.new_zeros(1)])
    ext.scatter_(0, torch.where(vic >= 0, vic, S), 1)
    open_.copy_(ext[:S])
    open_[sl] = torch.where(won, 0, open_[sl])


def _gs_sweeps_plain(mat, p, owner, sunk, open_, eps, sink, sched, r0,
                     max_rounds, ts):
    """Gauss-Seidel sweeps over the active tiles (state updated in place);
    ``mat`` rows are the benefits.  Returns the sweep count."""
    S = mat.shape[0]
    n_tiles = S // ts
    sched = sched.to(p.device)
    r = r0
    while True:
        per_tile = open_.view(n_tiles, ts).sum(dim=1)
        if int(per_tile.sum()) == 0 or r >= max_rounds:
            break
        eps_r = eps * sched[r]
        for t in torch.nonzero(per_tile > 0).flatten().tolist():
            sl = slice(t * ts, (t + 1) * ts)
            gid = torch.arange(t * ts, (t + 1) * ts, device=p.device)
            _tile_bid_resolve(mat[sl], sl, gid, p, owner, sunk, open_, eps_r,
                              sink)
        r += 1
    return r


def auction_phase_gs_plain(b, p0, owner0, sunk0, open0, eps, sink,
                           max_rounds: int, ts: int, sched=None,
                           complete_open: bool = False):
    """Plain PyTorch version of K2 (same contract as the kernel)."""
    S, C = b.shape
    dev = b.device
    p = p0.to(torch.float32).clone()
    owner = owner0.to(torch.int32).clone()
    sunk = sunk0.to(torch.int32).clone()
    open_ = open0.to(torch.int32).clone()
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    eps_t = torch.tensor(_f32(eps), dtype=torch.float32, device=dev)
    sink = _f32(sink)
    r = _gs_sweeps_plain(b, p, owner, sunk, open_, eps_t, sink, sched, 0,
                         int(max_rounds), ts)
    gcol = torch.full((S,), -1, dtype=torch.int32, device=dev)
    if complete_open:
        for t in range(S // ts):
            sl = slice(t * ts, (t + 1) * ts)
            v = b[sl].to(torch.float32) - p[None, :]
            j1 = torch.argmax(v, dim=1)
            v1 = v.gather(1, j1[:, None])[:, 0]
            gcol[sl] = torch.where(open_[sl] > 0,
                                   torch.where(v1 > sink, j1, C),
                                   -1).to(torch.int32)
    return p, owner, sunk, r, gcol


def factor_benefits(ks, kt, fd, mask_s, mask_t, wed, wfd, scale,
                    mult_blend: bool = False):
    """[S, C] float32 benefits rebuilt from FD and the (x, y, z, |x|^2)
    factor rows, in the same operation order as the CUDA kernel."""
    _, cd = factor_cost(ks, kt, fd, wed, wfd, scale, mult_blend)
    return torch.where(mask_s[:, None] & mask_t[None, :], -cd, NEG)


def auction_warm_fused_plain(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd,
                             scale, p0, owner0, acol0, sunk0, own_ok, sink,
                             eps_abs, rel_eps, dpen, max_rounds: int,
                             ts: int, sched=None, mult_blend: bool = False):
    """Plain PyTorch version of K3: sweep 0, keep test + round 0, GS
    sweeps on the rebuilt benefits, greedy completion from the hints."""
    S, C = fd.shape
    dev = fd.device
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=dev)
    sink_f = _f32(sink)
    sink_t = f(sink)
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    bt = factor_benefits(_factors(kp_s), _factors(kp_t), fd, mask_s, mask_t,
                         wed, wfd, scale, mult_blend)
    p0 = p0.to(torch.float32)
    # ---- sweep 0 ----
    v = bt - p0[None, :]
    j1 = torch.argmax(v, dim=1)
    v1 = v.gather(1, j1[:, None])[:, 0]
    cols = torch.arange(C, device=dev)
    v2 = torch.where(cols[None, :] == j1[:, None], NEG, v).amax(dim=1)
    acol0 = acol0.to(torch.int64)
    real0 = (acol0 >= 0) & (acol0 < C)
    vsel = torch.where(real0, torch.clamp(
        v.gather(1, torch.where(real0, acol0, 0)[:, None])[:, 0], min=NEG),
        NEG)
    bmax = torch.clamp(bt.amax(), min=NEG)
    del v
    # ---- keep test, release, round-0 bids ----
    spread = torch.clamp(bmax - sink_t, min=0.0)
    eps = torch.maximum(f(eps_abs), f(rel_eps) * spread)
    eps_keep = torch.minimum(torch.maximum(f(dpen) + 2.0 * eps, eps),
                             torch.maximum(spread / 8.0, eps))
    valid = mask_s.to(torch.bool)
    ownok = own_ok.to(torch.bool)
    thr = v1 - eps_keep
    keep = ownok & (vsel >= thr)
    stay_sunk = (sunk0 > 0) & (sink_t >= thr)
    open_t = valid & ~(keep | stay_sunk)
    to_sink = open_t & (v1 <= sink_f)
    sunk = ((stay_sunk | to_sink) | ~valid).to(torch.int32)
    bidding = open_t & ~to_sink
    open_ = bidding.to(torch.int32)
    owner = owner0.to(torch.int64).clone()
    rel = ownok & ~keep & real0
    ext = torch.cat([owner, owner.new_zeros(1)])
    ext.scatter_(0, torch.where(rel, acol0, C), -1)
    owner = ext[:C]
    delta = (v1 - torch.clamp(v2, min=sink_f)) + eps
    bidv = delta + p0[j1]
    gid = torch.arange(S, device=dev)
    ninf = torch.full((C,), float("-inf"), dtype=torch.float32, device=dev)
    wb = ninf.scatter_reduce(0, j1, torch.where(bidding, bidv, -torch.inf),
                             "amax")
    is_best = bidding & (bidv == wb[j1])
    big = torch.full((C,), _BIG, dtype=torch.int64, device=dev)
    win = big.scatter_reduce(0, j1, torch.where(is_best, gid, _BIG), "amin")
    has = win < _BIG
    vic = torch.where(has, owner, -1)
    owner = torch.where(has, win, owner).to(torch.int32)
    p = torch.where(has, wb, p0).clone()
    ext = torch.cat([open_, open_.new_zeros(1)])
    ext.scatter_(0, torch.where(has, win, S), 0)
    ext.scatter_(0, torch.where(vic >= 0, vic, S), 1)
    open_ = ext[:S].clone()
    # ---- Gauss-Seidel sweeps ----
    r = _gs_sweeps_plain(bt, p, owner, sunk, open_, eps, sink_f, sched, 1,
                         int(max_rounds), ts)
    # ---- greedy completion from the parked hints ----
    v1n = v1 + (p0[j1] - p[j1])
    gcol = torch.where(open_ > 0, torch.where(v1n > sink_f, j1, C),
                       -1).to(torch.int32)
    stats = torch.stack([bmax, torch.zeros_like(bmax), eps, eps_keep])
    return p, owner, sunk, r, gcol, stats


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("auction")
    if not getattr(lib, "_typed", False):
        lib.gs_phase.argtypes = ([_VP] * 8 + [_F, _F] + [_I] * 5
                                 + [_VP] * 3)
        lib.gs_phase.restype = _I
        lib.warm_fused.argtypes = ([_VP] * 10 + [_F] * 3 + [_I]
                                   + [_F] * 4 + [_I] * 4 + [_VP] * 16)
        lib.warm_fused.restype = _I
        lib._typed = True
    return lib


def _check_shapes(S, C, ts, what):
    if S % ts or C % 128 or S // ts > MAX_TILES:
        raise ValueError(f"{what}: needs S % ts == 0, C % 128 == 0 and at "
                         f"most {MAX_TILES} tiles (S={S}, C={C}, ts={ts})")


def auction_phase_gs_cuda(b, p0, owner0, sunk0, open0, eps, sink,
                          max_rounds: int, ts: int, sched=None,
                          complete_open: bool = False):
    """Launch K2 on the card (bf16 benefits)."""
    from ghicp_tpu_torch.ops._build import check, ptr
    S, C = b.shape
    _check_shapes(S, C, ts, "auction_phase_gs")
    if b.dtype != torch.bfloat16:
        raise ValueError("auction_phase_gs kernel takes bf16 benefits")
    dev = b.device
    b = b.contiguous()
    f32, i32 = torch.float32, torch.int32
    # state copies the kernel updates in place
    p = as_rows(p0, C, 0, f32, dev, "p0").clone()
    owner = as_rows(owner0, C, 0, i32, dev, "owner0").clone()
    sunk = as_rows(sunk0, S, 0, i32, dev, "sunk0").clone()
    open_ = as_rows(open0, S, 0, i32, dev, "open0").clone()
    gcol = torch.full((S,), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros((1,), dtype=torch.int32, device=dev)
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    sched = as_rows(sched, max(int(max_rounds), 1), 0, f32, dev, "sched")
    bid = torch.zeros((C,), dtype=torch.int64, device=dev)
    rowdec = torch.empty((ts,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().gs_phase(ptr(b), ptr(p), ptr(owner), ptr(sunk), ptr(open_),
                         ptr(gcol), ptr(rounds), ptr(sched), _f32(eps),
                         _f32(sink), int(max_rounds), int(bool(complete_open)),
                         S, C, ts, ptr(bid), ptr(rowdec),
                         _VP(stream))
    check(rc, "auction_phase_gs launch")
    count_launch("auction_phase_gs")
    return p, owner, sunk, rounds[0], gcol


def auction_phase_gs(b, p0, owner0, sunk0, open0, eps, sink, max_rounds: int,
                     ts: int = 128, esc_after: int = 0, esc_period: int = 1,
                     complete_open: bool = False):
    """One Gauss-Seidel auction phase.  Returns (p [C], owner [C],
    sunk [S], rounds, gcol [S]); ``gcol`` is the greedy completion of rows
    still open (-1 = was not open, C = sink) when ``complete_open``."""
    sched = escalation_schedule(max_rounds, esc_after, esc_period)
    args = (b, p0, owner0, sunk0, open0, eps, sink, int(max_rounds), ts,
            sched, complete_open)
    if require_device(b, "auction_phase_gs") == "cuda":
        return auction_phase_gs_cuda(*args)
    return auction_phase_gs_plain(*args)


def auction_warm_fused_cuda(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                            p0, owner0, acol0, sunk0, own_ok, sink, eps_abs,
                            rel_eps, dpen, max_rounds: int, ts: int,
                            sched=None, mult_blend: bool = False):
    """Launch K3 on the card (bf16 FD)."""
    from ghicp_tpu_torch.ops._build import check, ptr
    S, C = fd.shape
    _check_shapes(S, C, ts, "auction_warm_fused")
    if fd.dtype != torch.bfloat16:
        raise ValueError("auction_warm_fused kernel takes a bf16 FD matrix")
    dev = fd.device
    f32, i32 = torch.float32, torch.int32
    fd = fd.contiguous()
    ks = _factors(as_rows(kp_s, S, 3, f32, dev, "kp_s"))
    kt = _factors(as_rows(kp_t, C, 3, f32, dev, "kp_t"))
    ms = as_rows(mask_s, S, 0, i32, dev, "mask_s")
    mt = as_rows(mask_t, C, 0, i32, dev, "mask_t")
    p0 = as_rows(p0, C, 0, f32, dev, "p0")
    acol0 = as_rows(acol0, S, 0, i32, dev, "acol0")
    sunk0 = as_rows(sunk0, S, 0, i32, dev, "sunk0")
    own_ok = as_rows(own_ok, S, 0, i32, dev, "own_ok")
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    sched = as_rows(sched, max(int(max_rounds), 1), 0, f32, dev, "sched")
    p = p0.clone()
    owner = as_rows(owner0, C, 0, i32, dev, "owner0").clone()
    sunk = torch.zeros((S,), dtype=torch.int32, device=dev)
    open_ = torch.zeros((S,), dtype=torch.int32, device=dev)
    gcol = torch.full((S,), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros((1,), dtype=torch.int32, device=dev)
    stats = torch.zeros((4,), dtype=torch.float32, device=dev)
    bid = torch.zeros((C,), dtype=torch.int64, device=dev)
    rowdec = torch.empty((ts,), dtype=torch.int32, device=dev)
    vic = torch.empty((C,), dtype=torch.int32, device=dev)
    hv1 = torch.empty((S,), dtype=torch.float32, device=dev)
    hj1 = torch.empty((S,), dtype=torch.int32, device=dev)
    hv2 = torch.empty((S,), dtype=torch.float32, device=dev)
    hvsel = torch.empty((S,), dtype=torch.float32, device=dev)
    # orderable encoding of -3e38 (the benefit floor): ~bits(-3e38)
    neg_bits = int(torch.tensor([NEG], dtype=torch.float32)
                   .view(torch.int32)) & 0xFFFFFFFF
    bmax = torch.tensor([(~neg_bits) & 0x7FFFFFFF], dtype=torch.int32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().warm_fused(
        ptr(fd), ptr(ks), ptr(kt), ptr(ms), ptr(mt), ptr(p0), ptr(acol0),
        ptr(sunk0), ptr(own_ok), ptr(sched), _f32(wed), _f32(wfd),
        _f32(scale), int(bool(mult_blend)), _f32(sink), _f32(eps_abs),
        _f32(rel_eps), _f32(dpen),
        int(max_rounds), S, C, ts,
        ptr(p), ptr(owner), ptr(sunk), ptr(open_), ptr(gcol), ptr(rounds),
        ptr(stats), ptr(bid), ptr(rowdec), ptr(vic), ptr(hv1), ptr(hj1),
        ptr(hv2), ptr(hvsel), ptr(bmax), _VP(stream))
    check(rc, "auction_warm_fused launch")
    count_launch("auction_warm_fused_mult" if mult_blend
                 else "auction_warm_fused")
    return p, owner, sunk, rounds[0], gcol, stats


def auction_warm_fused(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale, p0,
                       owner0, acol0, sunk0, own_ok, sink, eps_abs, rel_eps,
                       dpen, max_rounds: int, ts: int = 128,
                       esc_after: int = 1, esc_period: int = 1,
                       mult_blend: bool = False):
    """Single-launch warm engine iteration.  ``p0`` [C] bidding-start
    prices; ``owner0`` [C] row id or -1; ``acol0`` [S] previous real column
    or -1; ``sunk0`` [S] (1 = previously sunk); ``own_ok`` [S] (row still
    owns its acol0 column).  Returns (p, owner, sunk, rounds, gcol,
    stats [b_max, 0, eps, eps_keep]); ``rounds`` counts round 0 too.
    ``mult_blend``: the FPFH/RoPS cost, k in the ``wfd`` slot."""
    sched = escalation_schedule(max_rounds, esc_after, esc_period)
    args = (kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale, p0, owner0,
            acol0, sunk0, own_ok, sink, eps_abs, rel_eps, dpen,
            int(max_rounds), ts, sched, mult_blend)
    if require_device(fd, "auction_warm_fused") == "cuda":
        return auction_warm_fused_cuda(*args)
    return auction_warm_fused_plain(*args)
