"""The GH-ICP registration engine (PyTorch port).

One iteration (:func:`make_body`): ED + CD blend -> matching -> Kabsch
(margin-weighted with Tukey IRLS after a KM matching) -> convergence test
-> IoU penalty-weight step.  The feature distance is computed once before
the loop.  Three blends: BSC's additive W_ED * ED + W_FD * FD with W_FD =
exp(-it / rate), FPFH/RoPS's multiplicative ED / max(FD, 1e-6)^k with FD a
similarity and k = 1 / (it + 1) (``mult_blend``; every kernel takes k in
its W_FD slot), and feature "none"'s CD = ED (W_ED = 1, W_FD = 0), each
with its own penalty schedule and price drift bound.  Three matchings: KM
(the auction), NN (each row's closest column under the penalty gate) and
NNR (reciprocal closest pairs).  The dense kernel lane (KM,
``fused_cost_kernel`` and keypoint capacities that are multiples of 128,
the JAX package's gate) runs two solve branches:

* the full solve — the fused benefit sweep (kernel K1) builds the
  benefit matrix, the CD statistics and the warm-start hints, then the
  auction runs through the Gauss-Seidel phase kernel (K2);
* the warm solve — BSC and FPFH/RoPS, once the penalty schedule is
  statistics-free and an assignment warm start exists (it > 1), at S, T >=
  1024, one launch of the warm fused kernel (K3) does the whole solve.

The kernels read the FD and store the benefits in bf16 or, under
``auction_bf16=False``, in float32 (their ``*_f32`` variants), as the JAX
package's fused lane does.

Otherwise the dense lane is the XLA lane (:func:`make_batched_body`): ED,
the blend and its penalty as plain tensor passes, then
:func:`ghicp_tpu_torch.matching.auction.auction_match` (the Jacobi rounds
with kernel K6, or the GS kernel under ``auction_round_kernel`` where its
shapes allow), or the NN / NNR matchers.  It is written over a leading pair axis:
:func:`ghicp_register_batched` runs one engine over P pairs, a pair that
has converged or reached ``max_iterations`` keeping its state (the JAX
package's vmapped ``while_loop``); a single pair runs it with P = 1.

On the streaming lane (``stream``: packed BSC factors, FPFH/RoPS
descriptor rows or :class:`NoFeatures`, no FD matrix) every KM iteration is
one matrix-free solve
(:func:`ghicp_tpu_torch.matching.stream_auction.stream_solve`, sweeps of
kernel K5), on BSC with a :class:`StreamCarry` of hints from one iteration
to the next that lets statistics-free iterations skip sweep 0 (the other
blends take no such shortcut, as in the JAX package); every NN / NNR
iteration one K5 sweep at zero prices (NNR with its column side).

Under a distributed ``comm`` (:mod:`ghicp_tpu_torch.core.comm`; the
entry points are in :mod:`ghicp_tpu_torch.shard`) each rank holds a row
shard of the source keypoints (and of the FD or the source factors) and
every cross-row reduction of an iteration goes through the ranks, as in
the JAX package's body: the CD statistics, the auction's bids and owners,
the matched-pair sums, the estimator's cross-covariance, the motion bound;
K3 is off there, as in the JAX gate.  Every value the host loop reads
(``converged``, the auction's open counts) is then the same on every rank.
With :class:`~ghicp_tpu_torch.ops.stream_kernel.RingFeatures` the
streaming lane sweeps through the ring (``ring_sweep``: the target's
factor blocks rotate over the ranks; BSC and KM only).

The loop is a host loop with one read of ``converged`` per iteration.
:func:`ghicp_register` stops there, as the JAX package's does.
:func:`ghicp_register_chunked` then runs, after a KM matching, the
one-to-one final matching (:func:`final_resolve`): on the dense lanes one
full-budget warm re-solve at the final pose, on the streaming lane a
deduplication of the last matching.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ghicp_tpu_torch.core import trace
from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.comm import LOCAL, Comm
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.matching.auction import (SINK, auction_match,
                                              auction_match_benefits,
                                              derive_acol)
from ghicp_tpu_torch.matching.cost import (blend_bsc, blend_fpfh,
                                           blend_none, bsc_penalty,
                                           euclidean_matrix, mult_penalty,
                                           none_penalty)
from ghicp_tpu_torch.matching.matchers import (BIG_ROW, MatchResult, nn_match,
                                               nnr_match)
from ghicp_tpu_torch.matching.stream_auction import (StreamCarry, carry_init,
                                                     stream_solve)
from ghicp_tpu_torch.ops.auction_rounds import (WarmInputs,
                                                auction_warm_fused,
                                                gs_tile_rows)
from ghicp_tpu_torch.ops.cost_kernel import (CostTarget, fused_benefit,
                                             mult_cost)
from ghicp_tpu_torch.ops.stream_kernel import (RingFeatures, ring_selected,
                                               ring_sweep, ring_target,
                                               stream_selected, stream_sweep,
                                               subset_rows, sweep_target)
from ghicp_tpu_torch.registration.estimator import estimate


class IterationMetrics(NamedTuple):
    """Per-iteration history, padded to max_iterations."""

    energy: torch.Tensor      # [I] assignment energy
    rmse: torch.Tensor        # [I] correspondence RMSE before the step
    rmse_after: torch.Tensor  # [I] after this iteration's transform
    cor: torch.Tensor         # [I] number of correspondences
    iou: torch.Tensor         # [I]
    penalty: torch.Tensor     # [I]
    rounds: torch.Tensor      # [I] auction sweeps
    # streaming lane only (0 on the dense lane): rows the keep test left
    # open, sweeps over a compacted block of open rows, and 1 where the
    # carry replaced sweep 0
    open_rows: torch.Tensor       # [I]
    compact_sweeps: torch.Tensor  # [I]
    fast: torch.Tensor            # [I]


class GHICPResult(NamedTuple):
    """One registration; the batched engine's fields gain a leading [P]
    axis (``iterations``, ``converged``, ``success`` and ``final_rmse``
    then are [P] tensors)."""

    transform: torch.Tensor   # [4, 4] source -> target
    iterations: int
    converged: bool
    success: bool             # final RMSE < 1.5 * non_max_radius
    final_rmse: float
    metrics: IterationMetrics
    matches: torch.Tensor     # [S] target index per source row (-1 none)


class _State(NamedTuple):
    """Loop state; the batched engine's tensors gain a leading [P] axis and
    ``it`` / ``converged`` are then host arrays [P]."""

    kps: torch.Tensor         # [S, 3] current source keypoints
    rt: torch.Tensor          # [4, 4] accumulated transform
    it: int
    converged: bool
    rms: torch.Tensor         # running RMSE (init 99999)
    fdm: torch.Tensor
    fdstd: torch.Tensor
    para1: torch.Tensor
    para2: torch.Tensor
    metrics: IterationMetrics
    matches: torch.Tensor     # [S]
    rmse_after: torch.Tensor
    prices: torch.Tensor      # [T] auction prices carried across iterations
    acol: torch.Tensor        # [S] raw assignment (col / SINK / -1)
    price_unc: torch.Tensor   # [T] per-column deflation depth
    pen_prev: torch.Tensor    # previous iteration's penalty
    it_shift: float           # schedule offset of W_FD
    scarry: StreamCarry       # streaming lane's hint carry (ok=False on the
                              # dense lane, None on the batched engine)


def _f(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _f32(x) -> float:
    return float(torch.tensor(float(x), dtype=torch.float32))


MULT_FEATURES = (FeatureType.FPFH, FeatureType.ROPS)


def warm_gate(S: int, T: int, config: GHICPConfig) -> bool:
    """Whether a dense engine of S x T keypoint slots takes the warm fused
    kernel K3 from its third iteration on: the JAX package's gate
    (``ghicp_tpu/registration/ghicp.py``, ``use_warm_kernel``), whose
    shape terms reach 131,072 columns through the tile height (K3 picks
    the replica form that fits a block, ``warm_replica_form``)."""
    ts = gs_tile_rows(T)
    return bool(config.warm_fused_kernel
                and config.feature in (FeatureType.BSC,) + MULT_FEATURES
                and config.auction_round_kernel
                and config.auction_phases == 1
                and S % ts == 0 and S >= 1024 and T >= 1024
                and ts * T <= 256 * 8192)


def blend_weights(it_eff: float, config: GHICPConfig):
    """(W_ED, W_FD) as float32-rounded host floats: BSC W_FD =
    exp(-it / rate); FPFH/RoPS (1, k = 1 / (it + 1)); none (1, 0)."""
    if config.feature in MULT_FEATURES:
        return 1.0, _f32(1.0 / _f32(it_eff + 1.0))
    if config.feature == FeatureType.NONE:
        return 1.0, 0.0
    wfd = torch.exp(torch.tensor(-_f32(it_eff), dtype=torch.float32)
                    / config.weight_changing_rate)
    return float(1.0 - wfd), float(wfd)


def fd_min_of(fd, mask_s, mask_t) -> torch.Tensor:
    """The least similarity over valid pairs (floored at 1e-6, per pair
    with a pair axis): the FPFH/RoPS lane's drift-bound input, measured
    once since the features are fixed."""
    m = mask_s[..., :, None] & mask_t[..., None, :]
    return torch.clamp(torch.where(m, fd.to(torch.float32), 1.0)
                       .amin(dim=(-2, -1)), min=1e-6)


def mult_drift(d_ed, i_eff, fd_min):
    """FPFH/RoPS price-drift bound for the next warm start: only the ED
    rise can over-price a column, amplified by at most fd_min^(-k_next),
    k_next = 1 / (i_eff + 2) (``i_eff`` float32, a tensor with a pair
    axis)."""
    i_eff = torch.as_tensor(i_eff, dtype=torch.float32).to(d_ed.device)
    k_next = 1.0 / (i_eff + 2.0)
    return d_ed * torch.exp(k_next * torch.log(1.0 / fd_min))


def masked_median_log(x: torch.Tensor, m: torch.Tensor,
                      comm: Comm = LOCAL) -> torch.Tensor:
    """Median of ``x`` over mask ``m`` along the last axis via a 128-bin
    log10 histogram over 1e-4..1e3 (resolution one bin, ~13%); one
    histogram per leading index (per pair on the batched engine).  The
    integer bin counts are summed over the ranks, exactly."""
    lo, hi, nb = -4.0, 3.0, 128
    lx = torch.log10(torch.clamp(x, min=1e-6))
    bi = torch.clamp(((lx - lo) / (hi - lo) * nb).to(torch.int64), 0, nb - 1)
    lead = x.shape[:-1]
    n_hist = math.prod(lead)
    off = torch.arange(n_hist, device=x.device).reshape(lead + (1,)) * nb
    hist = comm.psum(torch.bincount((bi + off)[m], minlength=n_hist * nb))
    csum = torch.cumsum(hist.reshape(lead + (nb,)), -1)
    n = csum[..., -1:]
    med_bin = torch.argmax((csum >= (n + 1) // 2).to(torch.int32), dim=-1)
    return torch.pow(torch.tensor(10.0, device=x.device),
                     lo + (med_bin.to(torch.float32) + 0.5) * (hi - lo) / nb)


def _rows_of(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pts[idx]`` per pair: [..., T, 3] rows at [..., S] indices."""
    return pts.gather(-2, idx[..., None].expand(idx.shape + (3,)))


def matched_stats(src_pts, tgt_pts, fsel, tgt_idx, w, comm: Comm = LOCAL):
    """RMSE / FDM / FDstd over matched pairs (per pair with a pair
    axis; over every rank's rows under a distributed ``comm``)."""
    t = _rows_of(tgt_pts, tgt_idx)
    n = torch.clamp(comm.psum(w.sum(dim=-1)), min=1.0)
    se = comm.psum((w * ((src_pts - t) ** 2).sum(dim=-1)).sum(dim=-1))
    rmse = torch.sqrt(se / n)
    s1 = comm.psum((w * fsel).sum(dim=-1))
    s2 = comm.psum((w * fsel * fsel).sum(dim=-1))
    fdm = s1 / n
    fdstd = torch.sqrt(torch.clamp(s2 / n - fdm * fdm, min=0.0))
    return rmse, fdm, fdstd


def initial_state(kp_s: torch.Tensor, n_target: int, config: GHICPConfig,
                  init_transform: Optional[torch.Tensor] = None,
                  it_shift: float = 0.0) -> _State:
    """Loop state at iteration 0 (optionally from a coarse pose); with
    kp_s [P, S, 3] (and init_transform [P, 4, 4]) the batched engine's."""
    dev = kp_s.device
    lead, S = kp_s.shape[:-2], kp_s.shape[-2]
    I = config.max_iterations
    if init_transform is None:
        rt0 = tf.identity(dev).expand(lead + (4, 4)).clone()
        kps0 = kp_s
    else:
        rt0 = init_transform.to(dev, torch.float32)
        kps0 = tf.apply(rt0, kp_s)
    full = lambda v, shape=lead, dt=torch.float32: torch.full(
        shape, v, dtype=dt, device=dev)
    zf = lambda: full(0.0, lead + (I,))
    zi = lambda: full(0, lead + (I,), torch.int64)
    metrics = IterationMetrics(energy=zf(), rmse=zf(), rmse_after=zf(),
                               cor=zi(), iou=zf(), penalty=zf(),
                               rounds=zi(), open_rows=zi(),
                               compact_sweeps=zi(), fast=zi())
    return _State(
        kps=kps0, rt=rt0, it=np.zeros(lead, np.int64) if lead else 0,
        converged=np.zeros(lead, bool) if lead else False,
        rms=full(99999.0), fdm=full(0.0), fdstd=full(0.0),
        para1=full(config.para1_penalty), para2=full(config.para2_penalty),
        metrics=metrics, matches=full(-1, lead + (S,), torch.int64),
        rmse_after=full(float("inf")),
        prices=full(0.0, lead + (n_target,)),
        acol=full(-1, lead + (S,), torch.int64),
        price_unc=full(3.0e38, lead + (n_target,)),
        pen_prev=full(0.0), it_shift=float(it_shift),
        scarry=None if lead else carry_init(S, dev))


def _check_lane(S: int, T: int, stream: bool) -> None:
    if stream and (S % 128 or T % 128):
        raise ValueError(f"keypoint capacities must be multiples of 128 "
                         f"(got {S}, {T})")


def _pairs_of(st: _State) -> _State:
    """A single-pair state as the batched engine's, P = 1 (views: the
    metrics buffers are shared)."""
    add = lambda x: x[None] if torch.is_tensor(x) else x
    return st._replace(
        **{f: add(getattr(st, f)) for f in st._fields
           if f not in ("it", "converged", "metrics")},
        it=np.array([st.it]), converged=np.array([st.converged]),
        metrics=IterationMetrics(*(x[None] for x in st.metrics)))


def _pair_of(st: _State) -> _State:
    """The single-pair state of a P = 1 batched state."""
    one = lambda x: x[0] if torch.is_tensor(x) else x
    return st._replace(
        **{f: one(getattr(st, f)) for f in st._fields
           if f not in ("it", "converged", "metrics")},
        it=int(st.it[0]), converged=bool(st.converged[0]),
        metrics=IterationMetrics(*(x[0] for x in st.metrics)))


def make_body(kp_t, mask_s, mask_t, fd, bbx_magnitude: float,
              config: GHICPConfig, stream=None, comm: Comm = LOCAL,
              total_rows: Optional[int] = None):
    """One GH-ICP iteration as a function ``_State -> _State``; with
    ``stream`` (factors, ``fd`` None) on the streaming lane.  Under a
    distributed ``comm``, ``mask_s`` (and ``fd``, the source factors and
    the state's rows) are this rank's rows of ``total_rows``."""
    S, T = mask_s.shape[0], kp_t.shape[0]
    total_rows = total_rows or S
    use_stream = stream is not None
    ring = isinstance(stream, RingFeatures)
    mult = config.feature in MULT_FEATURES
    bsc = config.feature == FeatureType.BSC
    none = config.feature == FeatureType.NONE
    km = config.correspondence == CorrespondenceType.KM
    nnr = config.correspondence == CorrespondenceType.NNR
    kernel_lane = (not use_stream and km and config.fused_cost_kernel
                   and S % 128 == 0 and T % 128 == 0)
    _check_lane(S, T, use_stream)
    if ring and not (km and bsc):
        raise ValueError("the ring lane takes BSC features and KM matching")
    if not use_stream and not kernel_lane:
        xla = make_batched_body(kp_t[None], mask_s[None], mask_t[None],
                                fd[None], [bbx_magnitude], config, comm,
                                total_rows)
        one = np.ones(1, bool)
        return lambda st: _pair_of(xla(_pairs_of(st), one))
    dev = kp_t.device
    scale = _f32(config.scale_factor * _f32(bbx_magnitude))
    scale_t = _f(scale, dev)
    ns = comm.psum(mask_s.to(torch.float32).sum())
    nt = mask_t.to(torch.float32).sum()
    rows = torch.arange(S, device=dev)
    gid = comm.axis_index() * S + rows      # global row ids
    # centre both keypoint sets by a common offset so the norm-expansion
    # ED stays float32-accurate at 100 m coordinates
    mid = 0.5 * (torch.where(mask_t[:, None], kp_t, 3e38).amin(dim=0)
                 + torch.where(mask_t[:, None], kp_t, -3e38).amax(dim=0))
    if use_stream:
        mid = comm.pmax(mid)     # one offset on every rank
    kp_t_c = torch.where(mask_t[:, None], kp_t - mid[None, :], 0.0)
    # the kernels' FD and benefit store: bf16, or float32 under
    # auction_bf16=False (the matched-pair gathers read the same copy)
    fd_b = None if use_stream else fd.to(
        torch.bfloat16 if config.auction_bf16 else torch.float32)
    fd_min = None if use_stream or not mult else comm.pmin(
        fd_min_of(fd, mask_s, mask_t))

    def penalty_of(st, it_eff, wed, wfd, mean, std):
        """The feature's penalty schedule from the CD statistics."""
        if mult:
            return mult_penalty(mean, it_eff, st.rms, st.para1, st.para2,
                                scale_t, config.penalty_initial)
        if none:
            return none_penalty(mean)
        return bsc_penalty(mean, std, it_eff, st.rms, st.fdm, st.fdstd,
                           st.para1, st.para2, scale_t, _f(wed, dev),
                           _f(wfd, dev), config.penalty_initial)
    ts_gs = gs_tile_rows(T)
    use_warm_kernel = (not use_stream and not comm.distributed
                       and warm_gate(S, T, config))
    # what every warm solve of this run reads unchanged (target factors,
    # masks, FD, the kernel's scratch), made once here
    warm_in = (WarmInputs(kp_t_c, fd_b, mask_s, mask_t, ts_gs)
               if use_warm_kernel else None)
    # what every K1 sweep of this run reads of the target, made once
    cost_tgt = (CostTarget(kp_t_c, mask_t)
                if not use_stream and dev.type == "cuda" else None)
    # what every streaming sweep of this run reads of the target, made once
    stream_tgt = (sweep_target(kp_t_c, stream, mask_t)
                  if use_stream and not ring and dev.type == "cuda"
                  else None)
    ring_tgt = (ring_target(kp_t_c, stream, mask_t)
                if ring and dev.type == "cuda" else None)

    def full_solve(st, it_eff, wed, wfd, budget, kps_c, p_mid):
        (b, cnt, s1, s2, _cm, ed_max_f, b_max, v1_mid,
         vsel_mid) = fused_benefit(kps_c, kp_t_c, fd_b, mask_s, mask_t, wed,
                                   wfd, scale, p_defl=p_mid, acol0=st.acol,
                                   with_stats=not bsc or not it_eff > 1.0,
                                   mult_blend=mult, target=cost_tgt)
        if comm.distributed:
            cnt, s1, s2 = comm.psum(torch.stack([cnt, s1, s2])).unbind()
            b_max, ed_max_f = comm.pmax(torch.stack([b_max,
                                                     ed_max_f])).unbind()
        n_valid = torch.clamp(cnt, min=1.0)
        mean = s1 / n_valid
        std = torch.sqrt(torch.clamp(s2 / n_valid - mean * mean, min=0.0))
        penalty = penalty_of(st, it_eff, wed, wfd, mean, std)
        dpen = torch.abs(penalty - st.pen_prev)
        ares = auction_match_benefits(
            b, penalty, mask_s, mask_t, eps_final=config.km_eps,
            max_rounds=budget, rel_eps=config.auction_rel_eps, p0=st.prices,
            price_uncertainty=st.price_unc + dpen,
            use_round_kernel=config.auction_round_kernel,
            n_phases=config.auction_phases, b_max=b_max, acol0=st.acol,
            hint_v1=v1_mid + dpen, hint_vsel=vsel_mid, keep_slack_extra=dpen,
            comm=comm, total_rows=total_rows)
        return (ares.match, ares.energy, ares.rounds, ares.prices, ares.acol,
                ares.cd_sel, penalty, ed_max_f, ares.punc)

    def warm_args(st, it_eff, wed, wfd, budget, kps_c, owner0, real0):
        """(penalty, p_start, positional and keyword arguments of the warm
        fused kernel) for one warm solve from state ``st``."""
        zero = _f(0.0, dev)
        penalty = penalty_of(st, it_eff, wed, wfd, zero, zero)
        dpen = torch.abs(penalty - st.pen_prev)
        p_start = torch.where(
            owner0 >= 0, torch.clamp(st.prices - (st.price_unc + dpen),
                                     min=0.0), 0.0)
        jc0 = torch.where(real0, st.acol, 0)
        own_ok = real0 & (owner0[jc0] == gid)
        acol_real = torch.where(real0, st.acol, -1)
        sunk0 = (st.acol == SINK).to(torch.int32)
        # sink and dpen stay on the device: the kernel reads them there
        args = (kps_c, kp_t_c, fd_b, mask_s, mask_t, wed, wfd, scale,
                p_start, owner0, acol_real, sunk0, own_ok, -penalty,
                config.km_eps, config.auction_rel_eps, dpen, budget)
        kwargs = dict(ts=ts_gs, esc_after=max(budget // 4, 1),
                      esc_period=max(budget // 16, 1), mult_blend=mult,
                      prep=warm_in)
        return penalty, p_start, args, kwargs

    def warm_solve(st, it_eff, wed, wfd, budget, kps_c, owner0, real0):
        penalty, p_start, args, kw = warm_args(st, it_eff, wed, wfd, budget,
                                               kps_c, owner0, real0)
        esc_after, esc_period = kw["esc_after"], kw["esc_period"]
        p_k, owner_k, sunk_k, r_k, gcol_k, stats_k = auction_warm_fused(
            *args, **kw)
        eps_k, eps_keep_k = stats_k[2], stats_k[3]
        ed_max_k = scale_t * (
            torch.where(mask_s, torch.linalg.norm(kps_c, dim=-1), 0.0).amax()
            + torch.where(mask_t, torch.linalg.norm(kp_t_c, dim=-1),
                          0.0).amax())
        acol_k = derive_acol(owner_k, sunk_k, S)
        g = gcol_k.to(torch.int64)
        acol_k = torch.where((acol_k == -1) & (g >= 0),
                             torch.where(g < T, g, SINK), acol_k)
        r_k = torch.as_tensor(r_k).to(dev)
        eps_bound = eps_k * torch.exp2(
            torch.clamp(r_k - esc_after, min=0).to(torch.float32)
            / float(esc_period))
        punc_k = torch.where(p_k != p_start, 2.0 * eps_bound, eps_keep_k)
        # matched-pair selection via factor gathers
        matched = (acol_k >= 0) & (acol_k < T)
        jc = torch.where(matched, acol_k, 0)
        tsel = kp_t_c[jc]
        dd = (kps_c * tsel).sum(dim=1)
        s2 = (kps_c * kps_c).sum(dim=1)
        t2 = (tsel * tsel).sum(dim=1)
        ed_sel = scale_t * torch.sqrt(torch.clamp(s2 + t2 - 2.0 * dd,
                                                  min=0.0))
        fd_sel = fd_b[rows, jc].to(torch.float32)
        if mult:
            cd_f = mult_cost(ed_sel, fd_sel, _f(wfd, dev))
        else:
            cd_f = _f(wed, dev) * ed_sel + _f(wfd, dev) * fd_sel
        bsel = torch.where(mask_s & mask_t[jc], -cd_f, -3.0e38)
        real_m = mask_s & matched & (bsel > -penalty)
        w_m = real_m.to(torch.float32)
        cor_m = w_m.sum()
        matched_cd = torch.where(real_m, -bsel, 0.0).sum()
        energy_k = matched_cd + penalty * (float(max(S, T)) - cor_m)
        match = MatchResult(tgt_idx=jc, w=w_m, n_matches=cor_m)
        return (match, energy_k, r_k, p_k, acol_k, -bsel, penalty, ed_max_k,
                punc_k)

    def stream_step(st, it_eff, wed, wfd, budget, kps_c):
        """One matrix-free solve; on BSC the fast path (carried hints
        instead of sweep 0) once the penalty schedule is statistics-free,
        with a full sweep 0 every ``stream_refresh_every`` iterations."""
        fast = config.stream_fast_path and bsc
        sf = it_eff > 1.0
        if config.stream_refresh_every > 0:
            sf = sf and st.it % config.stream_refresh_every != 0
        ring_fns = {}
        if ring:
            # the ring lane's sweeps rotate the target blocks (the compact
            # form gathers the open local rows, the ring still turns whole)
            ring_fns = dict(
                sweep_fn=lambda p, ac, with_stats=False: ring_sweep(
                    kps_c, kp_t_c, stream, mask_s, mask_t, p, ac, wed, wfd,
                    scale, comm, with_stats, target=ring_tgt),
                sweep_sub_fn=lambda idx, sub_mask, p, ac: ring_sweep(
                    kps_c[idx], kp_t_c, subset_rows(stream, idx), sub_mask,
                    mask_t, p, ac, wed, wfd, scale, comm, False,
                    target=ring_tgt),
                select_fn=lambda jc: ring_selected(kps_c, kp_t_c, stream,
                                                   jc, wed, wfd, scale))
        return stream_solve(
            kps_c, kp_t_c, stream, mask_s, mask_t, wed, wfd, scale,
            lambda mean, std: penalty_of(st, it_eff, wed, wfd, mean, std),
            eps_final=config.km_eps, rel_eps=config.auction_rel_eps,
            max_sweeps=budget, p0=st.prices,
            price_uncertainty=st.price_unc, acol0=st.acol,
            pen_prev=st.pen_prev, carry=st.scarry if fast else None,
            stats_free=sf and fast, open_cap=config.stream_open_cap,
            compact_extra_sweeps=config.stream_compact_budget,
            target=stream_tgt, comm=comm, total_rows=total_rows, **ring_fns)

    zero_p = torch.zeros((T,), dtype=torch.float32, device=dev)
    no_acol = torch.full((S,), -1, dtype=torch.int64, device=dev)

    def nn_stream_step(st, it_eff, wed, wfd, kps_c):
        """NN / NNR on the streaming lane: one sweep at zero prices, whose
        row top-1 is each row's closest column (v1 = -min CD); NN keeps a
        row below the penalty, NNR a row that is its column's lowest row
        at the column minimum (the sweep's column side).  Returns (match,
        fsel, cd_sel, penalty, ed_max)."""
        sw = stream_sweep(kps_c, kp_t_c, stream, mask_s, mask_t, zero_p,
                          no_acol, wed, wfd, scale, col_side=nnr,
                          target=stream_tgt)
        cnt, s1, s2 = comm.psum(torch.stack([sw.cnt, sw.cd_sum,
                                             sw.cd_sumsq])).unbind()
        n_valid = torch.clamp(cnt, min=1.0)
        mean = s1 / n_valid
        std = torch.sqrt(torch.clamp(s2 / n_valid - mean * mean, min=0.0))
        penalty = penalty_of(st, it_eff, wed, wfd, mean, std)
        mincd = -sw.v1
        ok = mask_s & (sw.v1 > -1.0e38)
        if nnr:
            # the lowest global row at each column's minimum over the ranks
            cmin = comm.pmin(sw.cmin)
            crow = torch.where(sw.crow < BIG_ROW, sw.crow + gid[0], BIG_ROW)
            tv = comm.pmin(torch.where(sw.cmin <= cmin, crow, BIG_ROW))
            ok = ok & (tv[sw.j1] == gid)
        else:
            ok = ok & (mincd < penalty)
        w = ok.to(torch.float32)
        fsel = stream_selected(kps_c, kp_t_c, stream, sw.j1, wed, wfd,
                               scale)[2]
        return (MatchResult(tgt_idx=sw.j1, w=w, n_matches=comm.psum(w.sum())),
                fsel, mincd, penalty, comm.pmax(sw.ed_max))

    def prepare(st):
        it_eff = _f32(st.it + st.it_shift)
        wed, wfd = blend_weights(it_eff, config)
        budget = config.auction_max_rounds
        # warm budgets serve the dense lanes only
        if (config.auction_warm_rounds > 0 and not use_stream
                and S >= config.auction_warm_min_rows
                and st.it > config.auction_warm_after):
            budget = config.auction_warm_rounds
        kps_c = st.kps - mid[None, :]
        real0 = (st.acol >= 0) & (st.acol < T)
        owner0 = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
        owner0.scatter_reduce_(0, torch.where(real0, st.acol, T),
                               torch.where(real0, gid, -1), "amax")
        return it_eff, wed, wfd, budget, kps_c, comm.pmax(owner0[:T]), real0

    def warm_kernel_args(st: _State):
        """(args, kwargs) of the warm fused kernel for a warm solve from
        ``st`` (the kernel's inputs on this iteration's path)."""
        return warm_args(st, *prepare(st))[2:]

    def body(st: _State) -> _State:
        it_eff, wed, wfd, budget, kps_c, owner0, real0 = prepare(st)
        if use_stream and not km:
            with trace.span("solve"):
                match, fsel, cd_sel, penalty, ed_max = nn_stream_step(
                    st, it_eff, wed, wfd, kps_c)
            with trace.span("estimate"):
                return _tail(st, match, _f(0.0, dev), 0, st.prices, st.acol,
                             cd_sel, penalty, ed_max,
                             torch.zeros_like(zero_p), fsel)
        if use_stream:
            with trace.span("solve"):
                sres = stream_step(st, it_eff, wed, wfd, budget, kps_c)
            with trace.span("estimate"):
                return _tail(st, sres.match, sres.energy, sres.rounds,
                             sres.prices, sres.acol, sres.cd_sel,
                             sres.penalty, sres.ed_max, sres.punc,
                             sres.fd_sel, sres)
        with trace.span("solve"):
            if use_warm_kernel and it_eff > 1.0 and st.it > 1:
                outs = warm_solve(st, it_eff, wed, wfd, budget, kps_c,
                                  owner0, real0)
            else:
                p_mid = torch.where(owner0 >= 0, torch.clamp(
                    st.prices - st.price_unc, min=0.0), 0.0)
                outs = full_solve(st, it_eff, wed, wfd, budget, kps_c, p_mid)
        (match, energy, rounds, prices, acol_new, cd_sel, penalty,
         ed_max, punc_new) = outs
        with trace.span("estimate"):
            return _tail(st, match, energy, rounds, prices, acol_new, cd_sel,
                         penalty, ed_max, punc_new,
                         fd_b[rows, match.tgt_idx].to(torch.float32))

    def _tail(st, match, energy, rounds, prices, acol_new, cd_sel, penalty,
              ed_max, punc_new, fsel, sres=None):
        w = match.w
        tgt_idx = match.tgt_idx
        cor = comm.psum(w.sum())
        rmse, fdm, fdstd = matched_stats(st.kps, kp_t, fsel, tgt_idx, w,
                                         comm)
        iou = cor / torch.clamp(ns + nt - cor, min=1.0)
        tgt_pts = kp_t[tgt_idx]
        w_est = w
        # margin weights and IRLS serve the KM gate; NN / NNR keep the plain
        # weights (their high-residual pairs carry the rotation)
        if config.confidence_weighting and km:
            margin = torch.clamp(penalty - cd_sel, min=0.0)
            margin = torch.where(w > 0, margin, 0.0)
            msum = torch.clamp(comm.psum(margin.sum()), min=1e-12)
            nw = torch.clamp(comm.psum(w.sum()), min=1.0)
            w_est = margin * (nw / msum)
        rt_step = estimate(st.kps, tgt_pts, w_est, dof=config.reg_dof,
                           comm=comm)
        for _ in range(config.robust_irls_rounds if km else 0):
            resid = torch.linalg.norm(tf.apply(rt_step, st.kps) - tgt_pts,
                                      dim=-1)
            rscale = masked_median_log(resid, w_est > 0, comm)
            c = config.robust_trim_c * rscale + 1e-12
            u = torch.clamp(resid / c, max=1.0)
            wr = w_est * (1.0 - u * u) ** 2
            rt_step = estimate(st.kps, tgt_pts, wr, dof=config.reg_dof,
                               comm=comm)
        R, t = tf.rotation(rt_step), tf.translation(rt_step)
        ang = tf.euler_deg_zyx(R)
        small = (torch.all(torch.abs(t) < config.converge_translation)
                 & torch.all(torch.abs(ang) < config.converge_rotation))
        kps_new = tf.apply(rt_step, st.kps)
        se_after = comm.psum((w * ((kps_new - tgt_pts) ** 2).sum(dim=-1))
                             .sum())
        rmse_after = torch.sqrt(se_after / torch.clamp(cor, min=1.0))
        ratio = config.weight_adjustment_ratio
        est = config.estimated_overlap
        iou_safe = torch.clamp(iou, min=1e-9)
        step = config.weight_adjustment_step
        delta = torch.where(est / iou_safe > ratio, step,
                            torch.where(iou_safe / est > ratio, -step, 0.0))
        m, i = st.metrics, st.it
        m.energy[i] = energy
        m.rmse[i] = rmse
        m.rmse_after[i] = rmse_after
        m.cor[i] = cor.to(torch.int64)
        m.iou[i] = iou
        m.penalty[i] = penalty
        m.rounds[i] = torch.as_tensor(rounds).to(m.rounds.device)
        if sres is not None:
            m.open_rows[i] = sres.open_rows
            m.compact_sweeps[i] = sres.compact_sweeps
            m.fast[i] = int(sres.fast)
        with trace.wait():
            flags = torch.stack([cor < config.min_cor, small]).cpu()
        converged = st.converged or bool(flags[0]) or bool(flags[1])
        matches = torch.where(w > 0, tgt_idx, -1)
        max_disp = comm.pmax(torch.where(
            mask_s, torch.linalg.norm(kps_new - st.kps, dim=-1), 0.0).amax())
        d_ed = scale_t * max_disp
        r = config.weight_changing_rate
        i_eff = i + st.it_shift
        dwfd = math.exp(-i_eff / r) - math.exp(-(i_eff + 1.0) / r)
        if bsc:
            drift_next = d_ed + dwfd * (ed_max + d_ed)
        elif none:
            drift_next = d_ed
        elif fd_min is not None:
            drift_next = mult_drift(d_ed, _f32(i_eff), fd_min)
        else:
            # streaming similarity lane: no measured fd_min, cold start
            drift_next = 3.0e38
        scarry = st.scarry
        if sres is not None and config.stream_fast_path and bsc:
            # hints for the next fast solve: fresh or propagated row bounds,
            # the ED max inflated by this step's motion, and the two
            # wfd-decay rise bounds (global dwfd * fd_max and per-row ratio)
            wfd_next = math.exp(-(i_eff + 1.0) / r)
            scarry = StreamCarry(
                ok=True, v1_ub=sres.v1_next, b_max=sres.b_max_next,
                ed_max=ed_max + d_ed, fd_max=sres.fd_max, v1_drift=d_ed,
                fd_term=dwfd * sres.fd_max,
                decay_ratio=_f(dwfd / max(wfd_next, 1e-30), dev))
        return _State(
            kps=kps_new, rt=tf.compose(rt_step, st.rt), it=i + 1,
            converged=converged, rms=rmse, fdm=fdm, fdstd=fdstd,
            para1=st.para1 + delta, para2=st.para2 + delta, metrics=m,
            matches=matches, rmse_after=rmse_after, prices=prices,
            acol=acol_new, price_unc=punc_new + drift_next, pen_prev=penalty,
            it_shift=st.it_shift, scarry=scarry)

    body.warm_kernel_args = warm_kernel_args
    return body


def make_batched_body(kp_t, mask_s, mask_t, fd, bbx_magnitude,
                      config: GHICPConfig, comm: Comm = LOCAL,
                      total_rows: Optional[int] = None):
    """One GH-ICP iteration of the XLA lane over a leading pair axis, as a
    function ``(_State, active) -> _State``: kp_t [P, T, 3], masks [P, S] /
    [P, T], fd [P, S, T], ``bbx_magnitude`` P host floats; ``active`` [P]
    host bools.  Every pair runs the iteration; the inactive ones keep
    their state.  Per pair: ED and the feature's blend with its
    CD-statistics penalty, the auction with the price and assignment warm
    start (or the NN / NNR matcher, which leaves prices and assignment as
    they are), then the same tail as :func:`make_body`.  Under a
    distributed ``comm`` (one pair) the rows are this rank's of
    ``total_rows``."""
    P, S = mask_s.shape
    T = kp_t.shape[1]
    dev = kp_t.device
    fd = fd.to(torch.float32)
    mult = config.feature in MULT_FEATURES
    km = config.correspondence == CorrespondenceType.KM
    fd_min = (comm.pmin(fd_min_of(fd, mask_s, mask_t)) if mult and km
              else None)
    scale = torch.tensor([_f32(config.scale_factor * _f32(x))
                          for x in bbx_magnitude], device=dev)
    pair_mask = mask_s[:, :, None] & mask_t[:, None, :]
    ns = comm.psum(mask_s.to(torch.float32).sum(dim=-1))
    nt = mask_t.to(torch.float32).sum(dim=-1)
    warm_budget = (config.auction_warm_rounds > 0
                   and S >= config.auction_warm_min_rows)
    r = config.weight_changing_rate

    def body(st: _State, active: np.ndarray) -> _State:
        it_eff = (st.it.astype(np.float32)
                  + np.float32(st.it_shift)).astype(np.float32)
        budget = np.where(warm_budget & (st.it > config.auction_warm_after),
                          config.auction_warm_rounds,
                          config.auction_max_rounds)
        ed = euclidean_matrix(st.kps, kp_t, scale[:, None, None])
        if mult:
            cost = blend_fpfh(ed, fd, mask_s, mask_t,
                              torch.from_numpy(it_eff), st.rms, st.para1,
                              st.para2, scale, config.penalty_initial, comm)
        elif config.feature == FeatureType.NONE:
            cost = blend_none(ed, mask_s, mask_t, comm)
        else:
            cost = blend_bsc(ed, fd, mask_s, mask_t,
                             torch.from_numpy(it_eff), st.rms, st.fdm,
                             st.fdstd, st.para1, st.para2, scale, r,
                             config.penalty_initial, comm)
        ed_max = comm.pmax(ed.masked_fill_(~pair_mask, 0.0).amax(
            dim=(-2, -1)))
        del ed
        penalty = cost.penalty
        with trace.span("solve"):
            if km:
                dpen = torch.abs(penalty - st.pen_prev)
                ares = auction_match(
                    cost.cd, penalty, mask_s, mask_t, eps_final=config.km_eps,
                    max_rounds=budget, rel_eps=config.auction_rel_eps,
                    p0=st.prices,
                    price_uncertainty=st.price_unc + dpen[:, None],
                    quantize_bf16=config.auction_bf16,
                    use_round_kernel=config.auction_round_kernel,
                    n_phases=config.auction_phases, acol0=st.acol,
                    keep_slack_extra=dpen, active=active, comm=comm,
                    total_rows=total_rows)
                match, cd_sel, energy = ares.match, ares.cd_sel, ares.energy
                rounds, prices, acol, punc = (ares.rounds.to(dev),
                                              ares.prices, ares.acol,
                                              ares.punc)
            else:
                match = (nn_match(cost.cd, penalty, mask_s, mask_t, comm)
                         if config.correspondence == CorrespondenceType.NN
                         else nnr_match(cost.cd, mask_s, mask_t, comm))
                cd_sel = cost.cd.gather(-1, match.tgt_idx[..., None])[..., 0]
                energy = torch.zeros((P,), dtype=torch.float32, device=dev)
                rounds = torch.zeros((P,), dtype=torch.int64, device=dev)
                prices, acol = st.prices, st.acol
                punc = torch.zeros_like(st.price_unc)
        del cost
        w, tgt_idx = match.w, match.tgt_idx
        cor = comm.psum(w.sum(dim=-1))
        fsel = fd.gather(-1, tgt_idx[..., None])[..., 0]
        rmse, fdm, fdstd = matched_stats(st.kps, kp_t, fsel, tgt_idx, w,
                                         comm)
        iou = cor / torch.clamp(ns + nt - cor, min=1.0)
        tgt_pts = _rows_of(kp_t, tgt_idx)
        w_est = w
        if config.confidence_weighting and km:
            margin = torch.clamp(penalty[:, None] - cd_sel, min=0.0)
            margin = torch.where(w > 0, margin, 0.0)
            msum = torch.clamp(comm.psum(margin.sum(dim=-1)), min=1e-12)
            nw = torch.clamp(comm.psum(w.sum(dim=-1)), min=1.0)
            w_est = margin * (nw / msum)[:, None]
        rt_step = estimate(st.kps, tgt_pts, w_est, dof=config.reg_dof,
                           comm=comm)
        for _ in range(config.robust_irls_rounds if km else 0):
            resid = torch.linalg.norm(tf.apply(rt_step, st.kps) - tgt_pts,
                                      dim=-1)
            rscale = masked_median_log(resid, w_est > 0, comm)
            c = config.robust_trim_c * rscale + 1e-12
            u = torch.clamp(resid / c[:, None], max=1.0)
            wr = w_est * (1.0 - u * u) ** 2
            rt_step = estimate(st.kps, tgt_pts, wr, dof=config.reg_dof,
                               comm=comm)
        ang = tf.euler_deg_zyx(tf.rotation(rt_step))
        small = ((torch.abs(tf.translation(rt_step))
                  < config.converge_translation).all(dim=-1)
                 & (torch.abs(ang) < config.converge_rotation).all(dim=-1))
        kps_new = tf.apply(rt_step, st.kps)
        se_after = comm.psum((w * ((kps_new - tgt_pts) ** 2).sum(dim=-1))
                             .sum(dim=-1))
        rmse_after = torch.sqrt(se_after / torch.clamp(cor, min=1.0))
        est = config.estimated_overlap
        iou_safe = torch.clamp(iou, min=1e-9)
        step = config.weight_adjustment_step
        ratio = config.weight_adjustment_ratio
        delta = torch.where(est / iou_safe > ratio, step,
                            torch.where(iou_safe / est > ratio, -step, 0.0))
        # metrics of the active pairs, at each one's own iteration
        m = st.metrics
        pa = torch.from_numpy(np.nonzero(active)[0]).to(dev)
        ia = torch.from_numpy(st.it[active]).to(dev)
        for buf, val in ((m.energy, energy), (m.rmse, rmse),
                         (m.rmse_after, rmse_after),
                         (m.cor, cor.to(torch.int64)), (m.iou, iou),
                         (m.penalty, penalty), (m.rounds, rounds)):
            buf[pa, ia] = val[pa].to(buf.dtype)
        with trace.wait():
            flags = torch.stack([cor < config.min_cor, small]).cpu().numpy()
        converged = st.converged | (active & (flags[0] | flags[1]))
        max_disp = comm.pmax(torch.where(
            mask_s, torch.linalg.norm(kps_new - st.kps, dim=-1),
            0.0).amax(dim=-1))
        d_ed = scale * max_disp
        i_eff = st.it + st.it_shift
        if fd_min is not None:
            drift_next = mult_drift(d_ed, torch.from_numpy(
                i_eff.astype(np.float32)), fd_min)
        elif mult:
            # NN / NNR with the similarity blend: no measured fd_min
            drift_next = torch.full_like(d_ed, 3.0e38)
        elif config.feature == FeatureType.NONE:
            drift_next = d_ed
        else:
            dwfd = torch.tensor([math.exp(-i / r) - math.exp(-(i + 1.0) / r)
                                 for i in i_eff], dtype=torch.float32,
                                device=dev)
            drift_next = d_ed + dwfd * (ed_max + d_ed)
        new = dict(kps=kps_new, rt=tf.compose(rt_step, st.rt), rms=rmse,
                   fdm=fdm, fdstd=fdstd, para1=st.para1 + delta,
                   para2=st.para2 + delta,
                   matches=torch.where(w > 0, tgt_idx, -1),
                   rmse_after=rmse_after, prices=prices, acol=acol,
                   price_unc=punc + drift_next[:, None], pen_prev=penalty)
        act = torch.from_numpy(active).to(dev)
        return st._replace(
            **{k: torch.where(act.reshape((P,) + (1,) * (v.ndim - 1)), v,
                              getattr(st, k)) for k, v in new.items()},
            it=st.it + active, converged=converged)

    return body


def final_resolve(state: _State, kp_t, mask_s, mask_t, fd,
                  bbx_magnitude: float, config: GHICPConfig, stream=None):
    """The one-to-one final matching.  Dense lane: one full-budget KM
    re-solve at the final pose, at the absolute ``km_eps``; streaming lane:
    no extra solve, the last iteration's matching.  Either is then
    deduplicated to one row per column (the highest row id keeps it).
    Returns (matches [S], n_matches, rmse)."""
    dev = kp_t.device
    S, T = state.kps.shape[0], kp_t.shape[0]
    if stream is not None:
        real = (state.acol >= 0) & (state.acol < T)
        tgt_idx = torch.where(real, state.acol, 0)
        w = (state.matches >= 0).to(torch.float32)
    else:
        scale = _f32(config.scale_factor * _f32(bbx_magnitude))
        it_eff = _f32(max(state.it - 1, 0) + state.it_shift)
        wed, wfd = blend_weights(it_eff, config)
        ed = euclidean_matrix(state.kps, kp_t, _f(scale, dev))
        if config.feature in MULT_FEATURES:
            cd = ed / torch.pow(torch.clamp(fd.to(torch.float32), min=1e-6),
                                _f(wfd, dev))
        elif config.feature == FeatureType.NONE:
            cd = ed
        else:
            cd = _f(wed, dev) * ed + _f(wfd, dev) * fd.to(torch.float32)
        cd = torch.where(mask_s[:, None] & mask_t[None, :], cd, torch.inf)
        del ed
        ares = auction_match(cd, state.pen_prev, mask_s, mask_t,
                             eps_final=config.km_eps,
                             max_rounds=config.final_resolve_rounds,
                             rel_eps=0.0, p0=state.prices,
                             price_uncertainty=state.price_unc,
                             quantize_bf16=config.auction_bf16,
                             use_round_kernel=config.auction_round_kernel,
                             n_phases=1, acol0=state.acol,
                             keep_slack_extra=0.0)
        tgt_idx, w = ares.match.tgt_idx, ares.match.w
    rows = torch.arange(S, device=dev)
    own = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
    own.scatter_reduce_(0, torch.where(w > 0, tgt_idx, T), rows, "amax")
    keep1 = (w > 0) & (own[tgt_idx] == rows)
    w1 = keep1.to(torch.float32)
    matches = torch.where(keep1, tgt_idx, -1)
    n = torch.clamp(w1.sum(), min=1.0)
    se = (w1 * ((state.kps - kp_t[tgt_idx]) ** 2).sum(dim=-1)).sum()
    return matches, trace.read(int, w1.sum()), torch.sqrt(se / n)


def _on_device(dev, kp_s, mask_s, kp_t, mask_t):
    """Keypoints (float32) and masks (bool) on ``dev``."""
    to = lambda x, dt: torch.as_tensor(x).to(dev, dt)
    return (to(kp_s, torch.float32), to(mask_s, torch.bool),
            to(kp_t, torch.float32), to(mask_t, torch.bool))


def _loop(kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude, config,
          init_transform, it_shift, device, iteration_callback, stream,
          comm: Comm = LOCAL, total_rows: Optional[int] = None,
          chunk: Optional[int] = None, overhead_out: Optional[dict] = None):
    """Inputs on ``device`` and the GH-ICP loop run to convergence (or
    ``max_iterations``); under a distributed ``comm`` on this rank's rows
    of ``total_rows``.  The callback's cadence is ``chunk`` iterations
    (default ``config.engine_chunk``); ``overhead_out`` (a dict) receives
    ``dispatch_overhead``, the seconds of one more entry into the loop
    with the finished state.  Returns (state, kp_t, mask_s, mask_t, fd,
    bbx, stream) on the device."""
    dev = resolve_device(device)
    to = lambda x: torch.as_tensor(x).to(dev)
    kp_s, mask_s, kp_t, mask_t = _on_device(dev, kp_s, mask_s, kp_t, mask_t)
    if stream is not None:
        fd = None
        stream = type(stream)(*(to(x) if torch.is_tensor(x) else x
                                for x in stream))
    else:
        fd = to(fd).to(torch.float32)
    T0 = None if init_transform is None else to(init_transform)
    bbx = float(bbx_magnitude)
    state = initial_state(kp_s, kp_t.shape[0], config, T0, it_shift)
    body = make_body(kp_t, mask_s, mask_t, fd, bbx, config, stream, comm,
                     total_rows)

    chunk = chunk or config.engine_chunk

    def report(st):
        iteration_callback(st.it, st.kps.cpu().numpy(),
                           st.matches.cpu().numpy())

    def run(st):
        """The loop from ``st``; the callback fires where the JAX
        package's chunked loop returns to the host: every ``chunk``
        iterations and once at the end."""
        reported = None
        while not st.converged and st.it < config.max_iterations:
            st = body(st)
            if iteration_callback is not None and st.it % chunk == 0:
                report(st)
                reported = st.it
        return st, reported

    state, reported = run(state)
    if iteration_callback is not None and reported != state.it:
        report(state)
    if overhead_out is not None:
        # the fixed host cost of a pass: enter the loop once more with the
        # finished state (no iteration runs) and read its success flag to
        # the host, as the JAX package's probe redispatches its chunk
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        done, _ = run(state)
        bool(done.rmse_after < 1.5 * config.non_max_radius)
        overhead_out["dispatch_overhead"] = time.perf_counter() - t0
    return state, kp_t, mask_s, mask_t, fd, bbx, stream


def _result(state: _State, final_rmse, matches, config: GHICPConfig):
    return GHICPResult(transform=state.rt, iterations=state.it,
                       converged=state.converged,
                       success=final_rmse < 1.5 * config.non_max_radius,
                       final_rmse=final_rmse, metrics=state.metrics,
                       matches=matches)


def ghicp_register(kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude: float,
                   config: GHICPConfig, init_transform=None,
                   it_shift: float = 0.0, device=None,
                   iteration_callback=None, stream=None) -> GHICPResult:
    """Run the GH-ICP loop to convergence (or ``max_iterations``) with no
    final matching: the success verdict reads the last iteration's matched
    RMSE, ``matches`` is the last iteration's.  Arguments as
    :func:`ghicp_register_chunked`."""
    state = _loop(kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude, config,
                  init_transform, it_shift, device, iteration_callback,
                  stream)[0]
    return _result(state, trace.read(float, state.rmse_after),
                   state.matches, config)


def ghicp_register_chunked(kp_s, mask_s, kp_t, mask_t, fd,
                           bbx_magnitude: float, config: GHICPConfig,
                           chunk: int = 8, init_transform=None,
                           it_shift: float = 0.0, stream=None,
                           iteration_callback=None,
                           overhead_out: Optional[dict] = None,
                           device=None) -> GHICPResult:
    """Run the GH-ICP loop to convergence (or ``max_iterations``), then,
    after a KM matching, the one-to-one final matching.  Inputs are moved
    to ``device`` (the card by default).  ``stream`` (``fd`` None: packed
    BSC factors, FPFH/RoPS ``DescFeatures`` or ``NoFeatures``) selects the
    streaming lane.  ``iteration_callback(it, kps, matches)`` gets host
    numpy copies every ``chunk`` iterations and when the loop ends, as the
    JAX package's chunked loop calls it.  ``overhead_out`` (a dict)
    receives ``dispatch_overhead``: the seconds of one more entry into the
    loop with the finished state, no iteration run and its flag read to
    the host, the fixed host cost of a pass (the JAX package's probe
    redispatches its chunk)."""
    state, kp_t, mask_s, mask_t, fd, bbx, stream = _loop(
        kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude, config,
        init_transform, it_shift, device, iteration_callback, stream,
        chunk=chunk, overhead_out=overhead_out)
    matches = state.matches
    final_rmse = trace.read(float, state.rmse_after)
    if (config.final_resolve_rounds > 0
            and config.correspondence == CorrespondenceType.KM):
        with trace.span("final"):
            matches, _, rmse = final_resolve(state, kp_t, mask_s, mask_t, fd,
                                             bbx, config, stream)
        final_rmse = trace.read(float, rmse)
    return _result(state, final_rmse, matches, config)


def ghicp_register_batched(kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude,
                           config: GHICPConfig, init_transform=None,
                           it_shift: float = 0.0, device=None
                           ) -> GHICPResult:
    """One engine over P pairs on a leading axis: kp_s [P, S, 3], mask_s
    [P, S], kp_t [P, T, 3], mask_t [P, T], fd [P, S, T], bbx_magnitude
    [P], ``init_transform`` [P, 4, 4] (optional, with the shared schedule
    offset ``it_shift``); every feature, with any matching.
    Both kernel flags are forced off, as in the JAX package: every pair
    runs the XLA lane (a KM auction bids through K6).
    Each iteration runs the body for every pair still going; a pair that
    has converged or reached ``max_iterations`` keeps its state.  No final
    matching.  Returns a :class:`GHICPResult` of [P] tensors."""
    cfg = dataclasses.replace(config, fused_cost_kernel=False,
                              auction_round_kernel=False)
    dev = resolve_device(device)
    to = lambda x: torch.as_tensor(x).to(dev)
    kp_s, mask_s, kp_t, mask_t = _on_device(dev, kp_s, mask_s, kp_t, mask_t)
    T0 = None if init_transform is None else to(init_transform)
    bbx = [float(x) for x in torch.as_tensor(bbx_magnitude).reshape(-1)]
    state = initial_state(kp_s, kp_t.shape[1], cfg, T0, it_shift)
    body = make_batched_body(kp_t, mask_s, mask_t, to(fd), bbx, cfg)
    while True:
        active = ~state.converged & (state.it < cfg.max_iterations)
        if not active.any():
            break
        state = body(state, active)
    return GHICPResult(
        transform=state.rt, iterations=torch.from_numpy(state.it),
        converged=torch.from_numpy(state.converged),
        success=state.rmse_after < 1.5 * cfg.non_max_radius,
        final_rmse=state.rmse_after, metrics=state.metrics,
        matches=state.matches)


def ghicp_register_batched_sharded(kp_s, mask_s, kp_t, mask_t, fd,
                                   bbx_magnitude, config: GHICPConfig,
                                   comm: Comm, init_transform=None,
                                   it_shift: float = 0.0, device=None
                                   ) -> GHICPResult:
    """P pairs on a leading axis (as :func:`ghicp_register_batched`) with
    the pairs split over ``comm``'s ranks: rank r takes pairs [r P / n,
    (r + 1) P / n) and runs each through the single-pair engine
    (:func:`ghicp_register`, kernels on: no collective crosses a pair),
    then every result field is all-gathered in pair order.  P must be a
    multiple of the rank count.  No final matching.  Returns a
    :class:`GHICPResult` of [P] tensors on every rank."""
    P = len(kp_s)
    n = comm.axis_size()
    if P % n:
        raise ValueError(f"pair count {P} not divisible by {n} ranks")
    dev = resolve_device(device)
    k = P // n
    bbx = [float(x) for x in torch.as_tensor(bbx_magnitude).reshape(-1)]
    outs = []
    for i in range(comm.axis_index() * k, (comm.axis_index() + 1) * k):
        outs.append(ghicp_register(
            kp_s[i], mask_s[i], kp_t[i], mask_t[i], fd[i], bbx[i], config,
            init_transform=(None if init_transform is None
                            else init_transform[i]),
            it_shift=it_shift, device=dev))
    gather = lambda xs: comm.all_gather(torch.stack(
        [torch.as_tensor(x).to(dev) for x in xs]))
    return GHICPResult(
        transform=gather([o.transform for o in outs]),
        iterations=gather([o.iterations for o in outs]),
        converged=gather([o.converged for o in outs]),
        success=gather([o.success for o in outs]),
        final_rmse=gather([o.final_rmse for o in outs]),
        metrics=IterationMetrics(*(gather([o.metrics[f] for o in outs])
                                   for f in range(len(IterationMetrics._fields)))),
        matches=gather([o.matches for o in outs]))
