"""Gauss-Seidel auction phase (kernel K2) and the single-launch warm
iteration (kernel K3), CUDA C++ in ``csrc/auction.cu``, and the Jacobi
auction rounds (kernels K7 and K8, one kernel in ``csrc/jacobi.cu``), with
their plain PyTorch versions.

K2 replaces ``ghicp_tpu/ops/auction_rounds.py::auction_phase_gs_pallas``
(Pallas ``_gs_kernel``); K3 replaces
``ghicp_tpu/ops/auction_rounds.py::auction_warm_fused_pallas`` (Pallas
``_warm_fused_kernel``), with its ``mult_blend`` branch (the FPFH/RoPS cost
ED * exp(-k log(max(FD, 1e-6))) in the benefit tile).  Both take their
matrix (K2's benefits, K3's FD) in bf16 or, on the ``auction_bf16=False``
lane, float32, and count the float32 launches under ``*_f32`` names.  Both
are bound by memory on this card: a full sweep reads the [S, C] matrix once
(134 MB in bf16 at 8192^2) and later sweeps only the row tiles with open
rows.  The design notes (one cooperative persistent launch, 64-bit
atomicMax bid resolution with the lowest-row tie rule, the exact sequential
tile order) are at the head of the CUDA source.

K7 replaces ``auction_rounds_pallas`` (a fixed number of synchronous
bidding rounds) and K8 ``auction_phase_pallas`` (rounds until no row is
open, under a runtime budget); their plain versions port the JAX package's
``auction_rounds_ref``.  No engine path of either package calls them.

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
import functools

import torch

from ghicp_tpu_torch.ops import as_rows, count_launch, require_device
from ghicp_tpu_torch.ops.cost_kernel import (_f32, _factors, factor_cost,
                                             orderable, target_factors)

NEG = -3.0e38
_BIG = 2**31 - 1
TRACE_SWEEPS = 30      # K3's trace: active tiles of at most this many sweeps
PART_MAX = 16          # K3: most column parts of one Gauss-Seidel row
_SMEM_MAX = 232448     # shared memory a block may take on this card
LUT_N = 0x3F81         # K3's table of the mult FD factor: bf16 0 ... 1.0
_LUT_BYTES = (LUT_N * 4 + 15) & ~15
_NEG_KEY = orderable(NEG)   # orderable key of the benefit floor NEG


def gs_tile_rows(C: int) -> int:
    """Row-tile height of the GS phase (the JAX package's ``_gs_ts``)."""
    ts = 256
    while ts > 16 and ts * C > 256 * 8192:
        ts //= 2
    return ts


def gs_smem_bytes(S: int, C: int, ts: int, form: int = 0) -> int:
    """The Gauss-Seidel sweeps' shared memory a block
    (``csrc/auction.cu::GsSmem``): a tile's keys, rows and columns, the
    tile counts and list, part slots and the replica's part in shared
    memory: form 0 the prices and owners [C] and the open flags [S], form 1
    the prices and open flags (the owners in a global slice a block), form
    2 none (all three in global slices)."""
    rep = {0: 8 * C, 1: 4 * C, 2: 0}[form]
    if form <= 1:
        rep += (S + 15) & ~15
    return rep + 16 * ts + 8 * (S // ts) + 16 * 16 + 12 * 1024 + 16


def gs_replica_form(S: int, C: int, ts: int) -> int:
    """K2's replica form at this shape (``csrc/auction.cu::gs_phase_form``):
    the first of 0, 1, 2 (:func:`gs_smem_bytes`) that fits a block's shared
    memory (0 to about 23,500 slots, 1 to about 42,000, 2 past that); -1
    no form (more than 512 rows a tile, or a tile scratch past a block's
    shared memory even in form 2).  The tile count has no cap of its own:
    the tile counts and list take 8 bytes a tile of that scratch."""
    if ts > 512:
        return -1
    return next((f for f in (0, 1, 2) if gs_smem_bytes(S, C, ts, f)
                 <= _SMEM_MAX), -1)


def warm_smem_bytes(S: int, C: int, ts: int, lut: bool = False,
                    form: int = 0) -> int:
    """K3's dynamic shared memory a block in replica form ``form``
    (``csrc/auction.cu::warm_smem``): the larger of sweep 0's staging (two
    buffers of six 1024-column arrays) and the Gauss-Seidel sweeps'
    (:func:`gs_smem_bytes`, with the replica's part in shared memory),
    plus the mult form's FD factor table with ``lut``."""
    stage = 2 * 6 * 1024 * 4
    return max(stage, gs_smem_bytes(S, C, ts, form)) + (_LUT_BYTES if lut
                                                         else 0)


def warm_replica_form(S: int, C: int, ts: int) -> int:
    """K3's replica form at this shape
    (``csrc/auction.cu::warm_fused_form``): the first of 0, 1, 2 whose
    shared memory without the mult form's table fits a block (as
    :func:`gs_replica_form`); -1 none."""
    if ts > 512:
        return -1
    return next((f for f in (0, 1, 2) if warm_smem_bytes(S, C, ts, False, f)
                 <= _SMEM_MAX), -1)


def warm_table_fits(S: int, C: int, ts: int) -> bool:
    """Whether K3's bf16 mult form keeps its FD factor table in shared
    memory beside the shape's replica form (else it computes expf / logf
    an entry)."""
    form = warm_replica_form(S, C, ts)
    return form >= 0 and warm_smem_bytes(S, C, ts, True, form) <= _SMEM_MAX


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
                     max_rounds, ts, active=None):
    """Gauss-Seidel sweeps over the active tiles (state updated in place);
    ``mat`` rows are the benefits.  Returns the sweep count; appends each
    sweep's (active tiles, open rows of those tiles as each was reached) to
    the list ``active``."""
    S = mat.shape[0]
    n_tiles = S // ts
    sched = sched.to(p.device)
    r = r0
    while True:
        per_tile = open_.view(n_tiles, ts).sum(dim=1)
        if int(per_tile.sum()) == 0 or r >= max_rounds:
            break
        eps_r = eps * sched[r]
        tiles = torch.nonzero(per_tile > 0).flatten().tolist()
        scans = 0
        for t in tiles:
            sl = slice(t * ts, (t + 1) * ts)
            if active is not None:
                scans += int(open_[sl].sum())
            gid = torch.arange(t * ts, (t + 1) * ts, device=p.device)
            _tile_bid_resolve(mat[sl], sl, gid, p, owner, sunk, open_, eps_r,
                              sink)
        if active is not None:
            active.append((len(tiles), scans))
        r += 1
    return r


def auction_phase_gs_plain(b, p0, owner0, sunk0, open0, eps, sink,
                           max_rounds: int, ts: int, sched=None,
                           complete_open: bool = False, trace=None):
    """Plain PyTorch version of K2 (same contract as the kernel; ``eps``
    and ``sink`` floats or float32 scalar tensors).  With ``trace`` (an
    int32 tensor of 3 + ``TRACE_SWEEPS``) the kernel's record: [rows open
    at the start, sweeps, rows scanned, active tiles of sweep 0, 1, ...]."""
    S, C = b.shape
    dev = b.device
    p = p0.to(torch.float32).clone()
    owner = owner0.to(torch.int32).clone()
    sunk = sunk0.to(torch.int32).clone()
    open_ = open0.to(torch.int32).clone()
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    eps_t = _device_scalar(eps, dev)
    sink = _device_scalar(sink, dev)
    active = [] if trace is not None else None
    n_open = int(open_.sum()) if trace is not None else 0
    r = _gs_sweeps_plain(b, p, owner, sunk, open_, eps_t, sink, sched, 0,
                         int(max_rounds), ts, active)
    if trace is not None:
        rec = ([n_open, r, sum(n for _, n in active)]
               + [a for a, _ in active[:TRACE_SWEEPS]])
        trace[:len(rec)] = torch.tensor(rec, dtype=torch.int32)
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
                             ts: int, sched=None, mult_blend: bool = False,
                             prep=None):
    """Plain PyTorch version of K3: sweep 0, keep test + round 0, GS
    sweeps on the rebuilt benefits, greedy completion from the hints.
    With ``prep`` (:class:`WarmInputs`) the target factors, the FD and the
    masks are its own, and its ``trace`` gets the kernel's record."""
    if prep is not None:
        kt, fd = prep.kt_rows, prep.fd
        mask_s, mask_t = prep.mask_s, prep.mask_t
    else:
        kt = _factors(kp_t)
    S, C = fd.shape
    dev = fd.device
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=dev)
    sink_f = _f32(sink)
    sink_t = f(sink)
    if sched is None:
        sched = escalation_schedule(max_rounds, 0, 1)
    bt = factor_benefits(_factors(kp_s), kt, fd, mask_s, mask_t, wed, wfd,
                         scale, mult_blend)
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
    active = []
    r = _gs_sweeps_plain(bt, p, owner, sunk, open_, eps, sink_f, sched, 1,
                         int(max_rounds), ts, active)
    if prep is not None:
        rec = ([int(bidding.sum()), r, sum(n for _, n in active)]
               + [a for a, _ in active[:TRACE_SWEEPS]])
        prep.trace[:len(rec)] = torch.tensor(rec, dtype=torch.int32)
    # ---- greedy completion from the parked hints ----
    v1n = v1 + (p0[j1] - p[j1])
    gcol = torch.where(open_ > 0, torch.where(v1n > sink_f, j1, C),
                       -1).to(torch.int32)
    stats = torch.stack([bmax, torch.zeros_like(bmax), eps, eps_keep])
    return p, owner, sunk, r, gcol, stats


def _matrix_dtype(x, what: str) -> bool:
    """True for a float32 matrix, False for bf16; anything else raises."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes a bf16 or float32 matrix, got "
                         f"{x.dtype}")
    return x.dtype == torch.float32


def _check_jacobi(b, what: str) -> None:
    S, C = b.shape
    if S % 128 or C % 128:
        raise ValueError(f"{what}: needs S % 128 == 0 and C % 128 == 0 "
                         f"(S={S}, C={C})")
    _matrix_dtype(b, what)


def _jacobi_round(bf, p, owner, sunk, eps, sink):
    """One synchronous bidding round (the JAX package's
    ``auction_rounds_ref`` body) on float32 benefits ``bf`` [S, C]; returns
    the new (p, owner, sunk).  Among equal best bids the highest row
    wins."""
    S, C = bf.shape
    dev = bf.device
    gid = torch.arange(S, device=dev)
    cols = torch.arange(C, device=dev)
    owned = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
    own = owner.to(torch.int64)
    owned[torch.where((own >= 0) & (own < S), own, S)] = True
    unassigned = ~owned[:S] & (sunk == 0)
    v = bf - p[None, :]
    j1 = torch.argmax(v, dim=1)
    v1 = v.gather(1, j1[:, None])[:, 0]
    v2 = torch.where(cols[None, :] == j1[:, None], NEG, v).amax(dim=1)
    del v
    to_sink = unassigned & (v1 <= sink)
    sunk = torch.where(to_sink, 1, sunk)
    bidding = unassigned & ~to_sink
    bid = ((p[j1] + v1) - torch.maximum(v2, sink)) + eps
    bid = torch.where(bidding, bid, NEG)
    win_bid = torch.full((C,), NEG, dtype=torch.float32, device=dev)
    win_bid = win_bid.scatter_reduce(0, j1, bid, "amax")
    wb = win_bid[j1]
    is_best = bidding & (bid == wb) & (wb > NEG / 2)
    winner = torch.full((C,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, j1, torch.where(is_best, gid, -1),
                                   "amax")
    has = winner >= 0
    return (torch.where(has, win_bid, p),
            torch.where(has, winner, own).to(torch.int32), sunk)


def _jacobi_plain(b, p0, owner0, sunk0, eps, sink, n_rounds: int,
                  early: bool):
    """``n_rounds`` rounds, or with ``early`` rounds while
    S - #owned columns - sum(sunk) > 0 and fewer than ``n_rounds`` ran."""
    dev = b.device
    S = b.shape[0]
    bf = b.to(torch.float32)
    f = lambda x: torch.tensor(_f32(x), dtype=torch.float32, device=dev)
    eps_t, sink_t = f(eps), f(sink)
    p = p0.to(device=dev, dtype=torch.float32).clone()
    owner = owner0.to(device=dev, dtype=torch.int32).clone()
    sunk = sunk0.to(device=dev, dtype=torch.int32).clone()
    r = 0
    while r < int(n_rounds):
        if early and S - int((owner >= 0).sum()) - int(sunk.sum()) <= 0:
            break
        p, owner, sunk = _jacobi_round(bf, p, owner, sunk, eps_t, sink_t)
        r += 1
    return p, owner, sunk, r


def auction_rounds_plain(b, p0, owner0, sunk0, eps, sink, n_rounds: int):
    """Plain PyTorch version of K7: ``n_rounds`` synchronous bidding rounds
    (a port of the JAX package's ``auction_rounds_ref``).  Returns (p [C],
    owner [C], sunk [S])."""
    return _jacobi_plain(b, p0, owner0, sunk0, eps, sink, n_rounds,
                         False)[:3]


def auction_phase_plain(b, p0, owner0, sunk0, eps, sink, max_rounds: int):
    """Plain PyTorch version of K8: the same rounds until no row is open
    (S - #owned columns - sum(sunk) == 0, tested before every round) or
    ``max_rounds`` ran.  Returns (p, owner, sunk, rounds)."""
    p, owner, sunk, r = _jacobi_plain(b, p0, owner0, sunk0, eps, sink,
                                      max_rounds, True)
    return p, owner, sunk, torch.tensor(r, dtype=torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("auction")
    if not getattr(lib, "_typed", False):
        lib.gs_phase.argtypes = ([_VP, _I] + [_VP] * 7 + [_I] * 5
                                 + [_VP] * 10 + [_I, _I, _VP])
        lib.gs_phase.restype = _I
        lib.gs_phase_form.argtypes = [_I, _I, _I]
        lib.gs_phase_form.restype = _I
        lib.gs_phase_smem.argtypes = [_I, _I, _I, _I]
        lib.gs_phase_smem.restype = ctypes.c_size_t
        lib.warm_fused.argtypes = ([_VP, _I, _I] + [_VP] * 11 + [_F] * 5
                                   + [_I] * 4 + [_VP] * 20 + [_I, _I, _VP])
        lib.warm_fused.restype = _I
        lib.warm_fused_smem.argtypes = [_I, _I, _I, _I, _I]
        lib.warm_fused_smem.restype = ctypes.c_size_t
        lib.warm_fused_form.argtypes = [_I, _I, _I]
        lib.warm_fused_form.restype = _I
        lib._typed = True
    return lib


def _jacobi_lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("jacobi")
    if not getattr(lib, "_typed", False):
        lib.jacobi_rounds.argtypes = ([_VP, _I] + [_VP] * 4 + [_F, _F]
                                      + [_I] * 4 + [_VP] * 4)
        lib.jacobi_rounds.restype = _I
        lib._typed = True
    return lib



def _check_shapes(S, C, ts, what):
    if S % ts or C % 128:
        raise ValueError(f"{what}: needs S % ts == 0 and C % 128 == 0 "
                         f"(S={S}, C={C}, ts={ts})")


def _replica_scratch(dev, S: int, C: int, form: int):
    """(blocks, (prices, owners, open flags)) of the replica's global
    slices, one a block, in replica form ``form`` (None where the form
    keeps that array in shared memory)."""
    if form == 0:
        return 0, (None, None, None)
    nblk = (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 1)
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    return nblk, (e((nblk, C), torch.float32) if form > 1 else None,
                  e((nblk, C), torch.int32),
                  e((nblk, S), torch.uint8) if form > 1 else None)


class GsScratch:
    """K2's scratch for one shape on one device, made once a process
    (:func:`gs_scratch`) and reused by every launch at that shape: the
    part slots, the trace and, in replica forms 1 and 2
    (:func:`gs_replica_form`; ``form`` forces a larger one), the replica's
    global slices, one a block; and the escalation tables on the device,
    one a (budget, esc_after, esc_period).  The scratch serves one launch
    at a time, on one stream.  After a launch ``trace`` holds [rows open
    at the start, sweeps, rows scanned, active tiles of sweep 0, 1, ...]
    (up to ``TRACE_SWEEPS`` sweeps)."""

    def __init__(self, dev, S: int, C: int, ts: int, form=None):
        self.dev = torch.device(dev)
        fit = gs_replica_form(S, C, ts)
        if fit < 0:
            raise ValueError(f"auction_phase_gs: S={S}, C={C}, ts={ts}: "
                             "more than 512 rows a tile, or the tile "
                             "scratch exceeds a block's shared memory")
        self.form = fit if form is None else int(form)
        if not fit <= self.form <= 2:
            raise ValueError(f"auction_phase_gs: replica form {form} at "
                             f"S={S}, C={C} (the shape's own is {fit})")
        e = lambda shape, dt: torch.empty(shape, dtype=dt, device=self.dev)
        self.part = e((2 * ts * PART_MAX * 3,), torch.float32)
        self.trace = torch.zeros((3 + TRACE_SWEEPS,), dtype=torch.int32,
                                 device=self.dev)
        self.nblk, rep = _replica_scratch(self.dev, S, C, self.form)
        self.replica = rep
        if self.dev.type == "cuda":
            lib = _lib()
            got = lib.gs_phase_form(S, C, ts)
            if got != fit:
                raise RuntimeError(f"auction_phase_gs: the kernel's replica "
                                   f"form {got}, gs_replica_form says {fit}")
            for f in (0, 1, 2):
                got = lib.gs_phase_smem(S, C, ts, f)
                if got != gs_smem_bytes(S, C, ts, f):
                    raise RuntimeError(
                        f"auction_phase_gs: the kernel takes {got} bytes of "
                        f"shared memory in form {f}, gs_smem_bytes says "
                        f"{gs_smem_bytes(S, C, ts, f)}")
        self.ptrs = tuple(0 if x is None else x.data_ptr()
                          for x in (self.part, self.trace, *rep))
        self._sched = {}

    def schedule(self, max_rounds: int, esc_after: int, esc_period: int):
        """The escalation table on this device, made once a key."""
        key = (int(max_rounds), int(esc_after), int(esc_period))
        if key not in self._sched:
            self._sched[key] = escalation_schedule(*key).to(self.dev)
        return self._sched[key]


def gs_scratch(dev, S: int, C: int, ts: int, form=None) -> GsScratch:
    """The :class:`GsScratch` of this shape (and ``form``) on ``dev``, made
    once."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _gs_scratch(dev, int(S), int(C), int(ts), form)


@functools.lru_cache(maxsize=8)
def _gs_scratch(dev, S: int, C: int, ts: int, form) -> GsScratch:
    return GsScratch(dev, S, C, ts, form)


def auction_phase_gs_cuda(b, p0, owner0, sunk0, open0, eps, sink,
                          max_rounds: int, ts: int, sched=None,
                          complete_open: bool = False, *, scratch=None):
    """Launch K2 on the card (bf16 or float32 benefits) with ``scratch``
    (:func:`gs_scratch` of the shape when None).  The start state is read,
    not updated: no clone; ``eps`` and ``sink`` reach the kernel as device
    scalars, so nothing is read back or copied from the host."""
    from ghicp_tpu_torch.ops._build import check
    S, C = b.shape
    _check_shapes(S, C, ts, "auction_phase_gs")
    f32_mat = _matrix_dtype(b, "auction_phase_gs")
    dev = b.device
    if scratch is None:
        scratch = gs_scratch(dev, S, C, ts)
    b = b.contiguous()
    f32, i32 = torch.float32, torch.int32
    p0 = as_rows(p0, C, 0, f32, dev, "p0")
    owner0 = as_rows(owner0, C, 0, i32, dev, "owner0")
    sunk0 = as_rows(sunk0, S, 0, i32, dev, "sunk0")
    open0 = as_rows(open0, S, 0, i32, dev, "open0")
    if sched is None:
        sched = scratch.schedule(max_rounds, 0, 1)
    sched = as_rows(sched, max(int(max_rounds), 1), 0, f32, dev, "sched")
    eps, sink = _device_scalar(eps, dev), _device_scalar(sink, dev)
    p = torch.empty((C,), dtype=f32, device=dev)
    owner, sunk, gcol, rounds = torch.empty(
        (C + 2 * S + 1,), dtype=i32, device=dev).split([C, S, S, 1])
    rc = _lib().gs_phase(
        b.data_ptr(), int(f32_mat), p0.data_ptr(), owner0.data_ptr(),
        sunk0.data_ptr(), open0.data_ptr(), sched.data_ptr(),
        eps.data_ptr(), sink.data_ptr(), int(max_rounds),
        int(bool(complete_open)), S, C, ts, p.data_ptr(), owner.data_ptr(),
        sunk.data_ptr(), gcol.data_ptr(), rounds.data_ptr(), *scratch.ptrs,
        scratch.nblk, scratch.form, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "auction_phase_gs launch")
    name = "auction_phase_gs_f32" if f32_mat else "auction_phase_gs"
    count_launch(name)
    count_launch(f"{name}@{S}")
    return p, owner, sunk, rounds.view(()), gcol


def auction_phase_gs(b, p0, owner0, sunk0, open0, eps, sink, max_rounds: int,
                     ts: int = 128, esc_after: int = 0, esc_period: int = 1,
                     complete_open: bool = False):
    """One Gauss-Seidel auction phase.  Returns (p [C], owner [C],
    sunk [S], rounds, gcol [S]); ``gcol`` is the greedy completion of rows
    still open (-1 = was not open, C = sink) when ``complete_open``.
    ``eps`` and ``sink`` are floats or float32 scalar tensors (on the card
    read there, no host round trip); the escalation table and the scratch
    are made once a shape (:func:`gs_scratch`)."""
    if require_device(b, "auction_phase_gs") == "cuda":
        scratch = gs_scratch(b.device, *b.shape, ts)
        return auction_phase_gs_cuda(
            b, p0, owner0, sunk0, open0, eps, sink, int(max_rounds), ts,
            scratch.schedule(max_rounds, esc_after, esc_period),
            complete_open, scratch=scratch)
    return auction_phase_gs_plain(
        b, p0, owner0, sunk0, open0, eps, sink, int(max_rounds), ts,
        escalation_schedule(max_rounds, esc_after, esc_period),
        complete_open)


class WarmInputs:
    """What every warm solve of one engine run reads unchanged, made once
    where the engine body is built and passed to each
    :func:`auction_warm_fused` call: the FD, the masks, the target factor
    rows ``kt_rows`` [C, 4] (x, y, z, |t|^2) and, for the kernel, ``kt``
    [5, C] (those columns and the target mask as 0 / 1); the escalation
    tables by (budget, esc_after, esc_period); on the card the kernel's
    scratch, with the replica's global slices in replica forms 1 and 2
    (:func:`warm_replica_form`; ``form`` forces a larger one).  The
    scratch serves one launch at a time, on one stream.
    After each call ``trace`` holds [rows open after the keep test, sweeps,
    rows scanned in the sweeps after round 0, active tiles of sweep 1, 2,
    ...] (up to ``TRACE_SWEEPS`` sweeps)."""

    def __init__(self, kp_t, fd, mask_s, mask_t, ts: int, form=None):
        S, C = fd.shape
        dev = fd.device
        self.ts = int(ts)
        fit = warm_replica_form(S, C, self.ts)
        if fit < 0:
            raise ValueError(f"auction_warm_fused: S={S}, C={C}, ts={ts}: "
                             "more than 512 rows a tile, or the tile "
                             "scratch exceeds a block's shared memory")
        self.form = fit if form is None else int(form)
        if not fit <= self.form <= 2:
            raise ValueError(f"auction_warm_fused: replica form {form} at "
                             f"S={S}, C={C} (the shape's own is {fit})")
        self.fd = fd.contiguous()
        self.mask_s = as_rows(mask_s, S, 0, torch.bool, dev, "mask_s")
        self.mask_t = as_rows(mask_t, C, 0, torch.bool, dev, "mask_t")
        self.kt_rows = _factors(as_rows(kp_t, C, 3, torch.float32, dev,
                                        "kp_t"))
        self.kt = target_factors(self.kt_rows[:, :3], self.mask_t)
        self.trace = torch.zeros((3 + TRACE_SWEEPS,), dtype=torch.int32,
                                 device=dev)
        self._sched = {}
        self.scratch = None
        if dev.type == "cuda":
            _check_shapes(S, C, self.ts, "auction_warm_fused")
            lib = _lib()
            got = lib.warm_fused_form(S, C, self.ts)
            if got != fit:
                raise RuntimeError(f"auction_warm_fused: the kernel's "
                                   f"replica form {got}, warm_replica_form "
                                   f"says {fit}")
            for lut in (False, True):
                for f in (0, 1, 2):
                    got = lib.warm_fused_smem(S, C, self.ts, int(lut), f)
                    want = warm_smem_bytes(S, C, self.ts, lut, f)
                    if got != want:
                        raise RuntimeError(
                            f"auction_warm_fused: the kernel takes {got} "
                            f"bytes of shared memory in form {f}, "
                            f"warm_smem_bytes says {want}")
            self.f32 = _matrix_dtype(self.fd, "auction_warm_fused")
            e = lambda n, dt: torch.empty((n,), dtype=dt, device=dev)
            i32, f32 = torch.int32, torch.float32
            # the kernel leaves bid and cnt at zero and bmax at the
            # orderable key of the benefit floor, as it finds them
            self.scratch = (
                torch.zeros((C,), dtype=torch.int64, device=dev),   # bid
                e(S, i32), e(C, i32),                               # open, vic
                e(S, f32), e(S, i32), e(S, f32), e(S, f32),         # hints
                e(2 * self.ts * PART_MAX * 3, f32),                 # part
                torch.full((1,), _NEG_KEY, dtype=i32, device=dev),  # bmax
                torch.zeros((1,), dtype=i32, device=dev))           # cnt
            self.nblk, rep = _replica_scratch(dev, S, C, self.form)
            self.replica = rep
            # the launch's fixed pointers, read once
            self.ptrs = tuple(x.data_ptr() for x in (
                self.fd, self.kt, self.mask_s, *self.scratch, self.trace))
            self.rep_ptrs = tuple(0 if x is None else x.data_ptr()
                                  for x in rep)

    def schedule(self, max_rounds: int, esc_after: int, esc_period: int):
        """The escalation table on this run's device, made once a key."""
        key = (int(max_rounds), int(esc_after), int(esc_period))
        if key not in self._sched:
            self._sched[key] = escalation_schedule(*key).to(self.fd.device)
        return self._sched[key]


def _device_scalar(x, dev) -> torch.Tensor:
    """A float32 scalar on ``dev`` for the kernel to read: a tensor as it
    is (no host round trip), a Python float filled on the device."""
    if torch.is_tensor(x):
        if x.dtype == torch.float32 and x.device == dev and x.numel() == 1:
            return x
        return x.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def auction_warm_fused_cuda(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale,
                            p0, owner0, acol0, sunk0, own_ok, sink, eps_abs,
                            rel_eps, dpen, max_rounds: int, ts: int,
                            sched=None, mult_blend: bool = False, *, prep):
    """Launch K3 on the card (bf16 or float32 FD) with the prepared
    ``prep`` (:class:`WarmInputs`; ``kp_t``, ``fd`` and the masks are
    its): no target factors and no host-to-device copy a call."""
    from ghicp_tpu_torch.ops._build import check
    S, C = prep.fd.shape
    dev = prep.fd.device
    if ts != prep.ts:
        raise ValueError(f"auction_warm_fused: ts {ts}, prepared for "
                         f"{prep.ts}")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    kps = as_rows(kp_s, S, 3, f32, dev, "kp_s")
    p0 = as_rows(p0, C, 0, f32, dev, "p0")
    if p0.data_ptr() % 16:
        p0 = p0.clone()
    owner0 = as_rows(owner0, C, 0, i64, dev, "owner0")
    acol0 = as_rows(acol0, S, 0, i64, dev, "acol0")
    sunk0 = as_rows(sunk0, S, 0, i32, dev, "sunk0")
    own_ok = as_rows(own_ok, S, 0, torch.bool, dev, "own_ok")
    if sched is None:
        sched = prep.schedule(max_rounds, 0, 1)
    sched = as_rows(sched, max(int(max_rounds), 1), 0, f32, dev, "sched")
    sink, dpen = _device_scalar(sink, dev), _device_scalar(dpen, dev)
    e = lambda n, dt: torch.empty((n,), dtype=dt, device=dev)
    p, owner, sunk, gcol = e(C, f32), e(C, i32), e(S, i32), e(S, i32)
    rounds, stats = e(1, i32), e(4, f32)
    fd_p, kt_p, ms_p, *scratch = prep.ptrs
    rc = _lib().warm_fused(
        fd_p, int(prep.f32), int(bool(mult_blend)), kps.data_ptr(), kt_p,
        ms_p, p0.data_ptr(), owner0.data_ptr(), acol0.data_ptr(),
        sunk0.data_ptr(), own_ok.data_ptr(), sched.data_ptr(),
        sink.data_ptr(), dpen.data_ptr(), wed, wfd, scale, eps_abs, rel_eps,
        int(max_rounds), S, C, ts, p.data_ptr(), owner.data_ptr(),
        sunk.data_ptr(), gcol.data_ptr(), rounds.data_ptr(),
        stats.data_ptr(), *scratch, *prep.rep_ptrs, prep.nblk, prep.form,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "auction_warm_fused launch")
    name = ("auction_warm_fused" + ("_mult" if mult_blend else "")
            + ("_f32" if prep.f32 else ""))
    count_launch(name)
    count_launch(f"{name}@{S}")
    return p, owner, sunk, rounds[0], gcol, stats


def auction_warm_fused(kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale, p0,
                       owner0, acol0, sunk0, own_ok, sink, eps_abs, rel_eps,
                       dpen, max_rounds: int, ts: int = 128,
                       esc_after: int = 1, esc_period: int = 1,
                       mult_blend: bool = False, prep=None):
    """Single-launch warm engine iteration.  ``p0`` [C] bidding-start
    prices; ``owner0`` [C] row id or -1; ``acol0`` [S] previous real column
    or -1; ``sunk0`` [S] (1 = previously sunk); ``own_ok`` [S] (row still
    owns its acol0 column); ``sink`` and ``dpen`` floats or float32 scalar
    tensors (read on the card, no host round trip).  ``prep``: the
    :class:`WarmInputs` of ``kp_t``, ``fd`` and the masks, made once by the
    caller for all solves against that target (then its tensors are used
    and those arguments only give the shapes); made here when None.
    Returns (p, owner, sunk, rounds, gcol, stats [b_max, 0, eps,
    eps_keep]); ``rounds`` counts round 0 too.  ``mult_blend``: the
    FPFH/RoPS cost, k in the ``wfd`` slot."""
    if prep is None:
        prep = WarmInputs(kp_t, fd, mask_s, mask_t, ts)
    sched = prep.schedule(max_rounds, esc_after, esc_period)
    args = (kp_s, kp_t, fd, mask_s, mask_t, wed, wfd, scale, p0, owner0,
            acol0, sunk0, own_ok, sink, eps_abs, rel_eps, dpen,
            int(max_rounds), ts, sched, mult_blend)
    if require_device(fd, "auction_warm_fused") == "cuda":
        return auction_warm_fused_cuda(*args, prep=prep)
    return auction_warm_fused_plain(*args, prep=prep)


def _jacobi_cuda(b, p0, owner0, sunk0, eps, sink, n_rounds: int,
                 early: bool, what: str):
    from ghicp_tpu_torch.ops._build import check, ptr
    S, C = b.shape
    f32_mat = b.dtype == torch.float32
    dev = b.device
    b = b.contiguous()
    p = as_rows(p0, C, 0, torch.float32, dev, "p0").clone()
    owner = as_rows(owner0, C, 0, torch.int32, dev, "owner0").clone()
    sunk = as_rows(sunk0, S, 0, torch.int32, dev, "sunk0").clone()
    rounds = torch.zeros((1,), dtype=torch.int32, device=dev)
    stamp = torch.zeros((S,), dtype=torch.int32, device=dev)
    key = torch.zeros((C,), dtype=torch.int64, device=dev)
    cnt = torch.zeros((4,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _jacobi_lib().jacobi_rounds(
        ptr(b), int(f32_mat), ptr(p), ptr(owner), ptr(sunk), ptr(rounds),
        _f32(eps), _f32(sink), int(n_rounds), int(bool(early)), S, C,
        ptr(stamp), ptr(key), ptr(cnt), _VP(stream))
    check(rc, f"{what} launch")
    count_launch(what + ("_f32" if f32_mat else ""))
    return p, owner, sunk, rounds[0]


def auction_rounds_cuda(b, p0, owner0, sunk0, eps, sink, n_rounds: int):
    """Launch K7 on the card: ``n_rounds`` fixed rounds."""
    return _jacobi_cuda(b, p0, owner0, sunk0, eps, sink, n_rounds, False,
                        "auction_rounds")[:3]


def auction_phase_cuda(b, p0, owner0, sunk0, eps, sink, max_rounds: int):
    """Launch K8 on the card: rounds until no row is open or
    ``max_rounds``."""
    return _jacobi_cuda(b, p0, owner0, sunk0, eps, sink, max_rounds, True,
                        "auction_phase")


def auction_rounds(b, p0, owner0, sunk0, eps, sink, n_rounds: int):
    """``n_rounds`` synchronous (Jacobi) bidding rounds at a fixed epsilon.

    b [S, C] bf16 or float32 benefits (computed in float32; very negative =
    no pair), p0 [C] start prices, owner0 [C] row id or -1, sunk0 [S] (1 =
    the row took the outside option ``sink``); S % 128 == 0, C % 128 == 0.
    Returns (p [C], owner [C] int32, sunk [S] int32).  CUDA tensors run K7,
    CPU tensors the plain version."""
    _check_jacobi(b, "auction_rounds")
    args = (b, p0, owner0, sunk0, eps, sink, int(n_rounds))
    if require_device(b, "auction_rounds") == "cuda":
        return auction_rounds_cuda(*args)
    return auction_rounds_plain(*args)


def auction_phase(b, p0, owner0, sunk0, eps, sink, max_rounds: int):
    """Jacobi bidding rounds until every row is owned or sunk or
    ``max_rounds`` ran (arguments as :func:`auction_rounds`).  Returns
    (p, owner, sunk, rounds).  CUDA tensors run K8, CPU tensors the plain
    version."""
    _check_jacobi(b, "auction_phase")
    args = (b, p0, owner0, sunk0, eps, sink, int(max_rounds))
    if require_device(b, "auction_phase") == "cuda":
        return auction_phase_cuda(*args)
    return auction_phase_plain(*args)
