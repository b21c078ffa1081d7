"""The GH-ICP registration engine, dense KM lane (PyTorch port).

One iteration (:func:`make_body`): ED + CD blend -> auction matching ->
margin-weighted robust Kabsch with Tukey IRLS -> convergence test -> IoU
penalty-weight step, with the feature distance computed once before the
loop.  Two solve branches, with the JAX package's gate:

* the full solve — the fused benefit sweep (kernel K1) builds the bf16
  benefit matrix, the CD statistics and the warm-start hints, then the
  auction runs through the Gauss-Seidel phase kernel (K2);
* the warm solve — once the BSC penalty schedule is statistics-free and an
  assignment warm start exists (it > 1), at S, T >= 1024, one launch of
  the warm fused kernel (K3) does the whole solve.

The loop is a host loop with one read of ``converged`` per iteration.
After it, one full-budget warm re-solve at the final pose gives the
one-to-one matching the success verdict reads (:func:`final_resolve`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.matching.auction import (SINK, auction_match,
                                              auction_match_benefits,
                                              derive_acol)
from ghicp_tpu_torch.matching.cost import bsc_penalty, euclidean_matrix
from ghicp_tpu_torch.matching.matchers import MatchResult
from ghicp_tpu_torch.ops.auction_rounds import (auction_warm_fused,
                                                gs_tile_rows)
from ghicp_tpu_torch.ops.cost_kernel import fused_benefit
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


class GHICPResult(NamedTuple):
    transform: torch.Tensor   # [4, 4] source -> target
    iterations: int
    converged: bool
    success: bool             # final RMSE < 1.5 * non_max_radius
    final_rmse: float
    metrics: IterationMetrics
    matches: torch.Tensor     # [S] target index per source row (-1 none)


class _State(NamedTuple):
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


def _f(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _f32(x) -> float:
    return float(torch.tensor(float(x), dtype=torch.float32))


def blend_weights(it_eff: float, config: GHICPConfig):
    """(W_ED, W_FD) as float32-rounded host floats: W_FD = exp(-it/rate)."""
    if config.feature != FeatureType.BSC:
        raise NotImplementedError("only the BSC lane is ported")
    wfd = torch.exp(torch.tensor(-_f32(it_eff), dtype=torch.float32)
                    / config.weight_changing_rate)
    return float(1.0 - wfd), float(wfd)


def masked_median_log(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` over mask ``m`` via a 128-bin log10 histogram over
    1e-4..1e3 (resolution one bin, ~13%)."""
    lo, hi, nb = -4.0, 3.0, 128
    lx = torch.log10(torch.clamp(x, min=1e-6))
    bi = torch.clamp(((lx - lo) / (hi - lo) * nb).to(torch.int64), 0, nb - 1)
    hist = torch.bincount(bi[m], minlength=nb)
    csum = torch.cumsum(hist, 0)
    n = csum[-1]
    med_bin = torch.argmax((csum >= (n + 1) // 2).to(torch.int32))
    return torch.pow(torch.tensor(10.0, device=x.device),
                     lo + (med_bin.to(torch.float32) + 0.5) * (hi - lo) / nb)


def matched_stats(src_pts, tgt_pts, fsel, tgt_idx, w):
    """RMSE / FDM / FDstd over matched pairs."""
    t = tgt_pts[tgt_idx]
    n = torch.clamp(w.sum(), min=1.0)
    se = (w * ((src_pts - t) ** 2).sum(dim=-1)).sum()
    rmse = torch.sqrt(se / n)
    s1 = (w * fsel).sum()
    s2 = (w * fsel * fsel).sum()
    fdm = s1 / n
    fdstd = torch.sqrt(torch.clamp(s2 / n - fdm * fdm, min=0.0))
    return rmse, fdm, fdstd


def initial_state(kp_s: torch.Tensor, n_target: int, config: GHICPConfig,
                  init_transform: Optional[torch.Tensor] = None,
                  it_shift: float = 0.0) -> _State:
    """Loop state at iteration 0 (optionally from a coarse pose)."""
    dev = kp_s.device
    S = kp_s.shape[0]
    I = config.max_iterations
    if init_transform is None:
        rt0, kps0 = tf.identity(dev), kp_s
    else:
        rt0 = init_transform.to(dev, torch.float32)
        kps0 = tf.apply(rt0, kp_s)
    zf = torch.zeros((I,), dtype=torch.float32, device=dev)
    zi = torch.zeros((I,), dtype=torch.int64, device=dev)
    metrics = IterationMetrics(energy=zf.clone(), rmse=zf.clone(),
                               rmse_after=zf.clone(), cor=zi.clone(),
                               iou=zf.clone(), penalty=zf.clone(),
                               rounds=zi.clone())
    return _State(
        kps=kps0, rt=rt0, it=0, converged=False, rms=_f(99999.0, dev),
        fdm=_f(0.0, dev), fdstd=_f(0.0, dev),
        para1=_f(config.para1_penalty, dev),
        para2=_f(config.para2_penalty, dev), metrics=metrics,
        matches=torch.full((S,), -1, dtype=torch.int64, device=dev),
        rmse_after=_f(float("inf"), dev),
        prices=torch.zeros((n_target,), dtype=torch.float32, device=dev),
        acol=torch.full((S,), -1, dtype=torch.int64, device=dev),
        price_unc=torch.full((n_target,), 3.0e38, dtype=torch.float32,
                             device=dev),
        pen_prev=_f(0.0, dev), it_shift=float(it_shift))


def _check_lane(config: GHICPConfig, S: int, T: int) -> None:
    if (config.feature != FeatureType.BSC
            or config.correspondence != CorrespondenceType.KM):
        raise NotImplementedError(
            "the port's engine runs the BSC + KM dense lane only")
    if not config.auction_bf16:
        raise NotImplementedError(
            "the port's kernels take a bf16 FD / benefit matrix; "
            "auction_bf16=False is not ported yet")
    if S % 128 or T % 128:
        raise ValueError(f"keypoint capacities must be multiples of 128 "
                         f"(got {S}, {T})")


def make_body(kp_t, mask_s, mask_t, fd, bbx_magnitude: float,
              config: GHICPConfig):
    """One GH-ICP iteration as a function ``_State -> _State``."""
    S, T = mask_s.shape[0], kp_t.shape[0]
    _check_lane(config, S, T)
    dev = kp_t.device
    scale = _f32(config.scale_factor * _f32(bbx_magnitude))
    scale_t = _f(scale, dev)
    ns = mask_s.to(torch.float32).sum()
    nt = mask_t.to(torch.float32).sum()
    rows = torch.arange(S, device=dev)
    # centre both keypoint sets by a common offset so the norm-expansion
    # ED stays float32-accurate at 100 m coordinates
    mid = 0.5 * (torch.where(mask_t[:, None], kp_t, 3e38).amin(dim=0)
                 + torch.where(mask_t[:, None], kp_t, -3e38).amax(dim=0))
    kp_t_c = torch.where(mask_t[:, None], kp_t - mid[None, :], 0.0)
    fd_b = fd.to(torch.bfloat16)
    ts_gs = gs_tile_rows(T)
    use_warm_kernel = (config.warm_fused_kernel and config.auction_phases == 1
                       and S % ts_gs == 0 and S >= 1024 and T >= 1024
                       and ts_gs * T <= 256 * 8192)

    def full_solve(st, it_eff, wed, wfd, budget, kps_c, p_mid):
        (b, cnt, s1, s2, _cm, ed_max_f, b_max, v1_mid,
         vsel_mid) = fused_benefit(kps_c, kp_t_c, fd_b, mask_s, mask_t, wed,
                                   wfd, scale, p_defl=p_mid, acol0=st.acol,
                                   with_stats=not it_eff > 1.0)
        n_valid = torch.clamp(cnt, min=1.0)
        mean = s1 / n_valid
        std = torch.sqrt(torch.clamp(s2 / n_valid - mean * mean, min=0.0))
        penalty = bsc_penalty(mean, std, it_eff, st.rms, st.fdm, st.fdstd,
                              st.para1, st.para2, scale_t, _f(wed, dev),
                              _f(wfd, dev), config.penalty_initial)
        dpen = torch.abs(penalty - st.pen_prev)
        ares = auction_match_benefits(
            b, penalty, mask_s, mask_t, eps_final=config.km_eps,
            max_rounds=budget, rel_eps=config.auction_rel_eps, p0=st.prices,
            price_uncertainty=st.price_unc + dpen,
            n_phases=config.auction_phases, b_max=b_max, acol0=st.acol,
            hint_v1=v1_mid + dpen, hint_vsel=vsel_mid, keep_slack_extra=dpen)
        return (ares.match, ares.energy, ares.rounds, ares.prices, ares.acol,
                ares.cd_sel, penalty, ed_max_f, ares.punc)

    def warm_args(st, it_eff, wed, wfd, budget, kps_c, owner0, real0):
        """(penalty, p_start, positional and keyword arguments of the warm
        fused kernel) for one warm solve from state ``st``."""
        zero = _f(0.0, dev)
        penalty = bsc_penalty(zero, zero, it_eff, st.rms, st.fdm, st.fdstd,
                              st.para1, st.para2, scale_t, _f(wed, dev),
                              _f(wfd, dev), config.penalty_initial)
        dpen = torch.abs(penalty - st.pen_prev)
        p_start = torch.where(
            owner0 >= 0, torch.clamp(st.prices - (st.price_unc + dpen),
                                     min=0.0), 0.0)
        jc0 = torch.where(real0, st.acol, 0)
        own_ok = real0 & (owner0[jc0] == rows)
        acol_real = torch.where(real0, st.acol, -1)
        sunk0 = (st.acol == SINK).to(torch.int32)
        args = (kps_c, kp_t_c, fd_b, mask_s, mask_t, wed, wfd, scale,
                p_start, owner0, acol_real, sunk0, own_ok, float(-penalty),
                config.km_eps, config.auction_rel_eps, float(dpen), budget)
        kwargs = dict(ts=ts_gs, esc_after=max(budget // 4, 1),
                      esc_period=max(budget // 16, 1))
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

    def prepare(st):
        it_eff = _f32(st.it + st.it_shift)
        wed, wfd = blend_weights(it_eff, config)
        budget = config.auction_max_rounds
        if (config.auction_warm_rounds > 0
                and S >= config.auction_warm_min_rows
                and st.it > config.auction_warm_after):
            budget = config.auction_warm_rounds
        kps_c = st.kps - mid[None, :]
        real0 = (st.acol >= 0) & (st.acol < T)
        owner0 = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
        owner0.scatter_reduce_(0, torch.where(real0, st.acol, T),
                               torch.where(real0, rows, -1), "amax")
        return it_eff, wed, wfd, budget, kps_c, owner0[:T], real0

    def warm_kernel_args(st: _State):
        """(args, kwargs) of the warm fused kernel for a warm solve from
        ``st`` (the kernel's inputs on this iteration's path)."""
        return warm_args(st, *prepare(st))[2:]

    def body(st: _State) -> _State:
        it_eff, wed, wfd, budget, kps_c, owner0, real0 = prepare(st)
        if use_warm_kernel and it_eff > 1.0 and st.it > 1:
            outs = warm_solve(st, it_eff, wed, wfd, budget, kps_c, owner0,
                              real0)
        else:
            p_mid = torch.where(owner0 >= 0, torch.clamp(
                st.prices - st.price_unc, min=0.0), 0.0)
            outs = full_solve(st, it_eff, wed, wfd, budget, kps_c, p_mid)
        (match, energy, rounds, prices, acol_new, cd_sel, penalty,
         ed_max, punc_new) = outs
        return _tail(st, match, energy, rounds, prices, acol_new, cd_sel,
                     penalty, ed_max, punc_new)

    def _tail(st, match, energy, rounds, prices, acol_new, cd_sel, penalty,
              ed_max, punc_new):
        w = match.w
        tgt_idx = match.tgt_idx
        cor = w.sum()
        fsel = fd_b[rows, tgt_idx].to(torch.float32)
        rmse, fdm, fdstd = matched_stats(st.kps, kp_t, fsel, tgt_idx, w)
        iou = cor / torch.clamp(ns + nt - cor, min=1.0)
        tgt_pts = kp_t[tgt_idx]
        w_est = w
        if config.confidence_weighting:
            margin = torch.clamp(penalty - cd_sel, min=0.0)
            margin = torch.where(w > 0, margin, 0.0)
            msum = torch.clamp(margin.sum(), min=1e-12)
            nw = torch.clamp(w.sum(), min=1.0)
            w_est = margin * (nw / msum)
        rt_step = estimate(st.kps, tgt_pts, w_est, dof=config.reg_dof)
        for _ in range(config.robust_irls_rounds):
            resid = torch.linalg.norm(tf.apply(rt_step, st.kps) - tgt_pts,
                                      dim=-1)
            rscale = masked_median_log(resid, w_est > 0)
            c = config.robust_trim_c * rscale + 1e-12
            u = torch.clamp(resid / c, max=1.0)
            wr = w_est * (1.0 - u * u) ** 2
            rt_step = estimate(st.kps, tgt_pts, wr, dof=config.reg_dof)
        R, t = tf.rotation(rt_step), tf.translation(rt_step)
        ang = tf.euler_deg_zyx(R)
        small = (torch.all(torch.abs(t) < config.converge_translation)
                 & torch.all(torch.abs(ang) < config.converge_rotation))
        kps_new = tf.apply(rt_step, st.kps)
        se_after = (w * ((kps_new - tgt_pts) ** 2).sum(dim=-1)).sum()
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
        flags = torch.stack([cor < config.min_cor, small]).cpu()
        converged = st.converged or bool(flags[0]) or bool(flags[1])
        matches = torch.where(w > 0, tgt_idx, -1)
        max_disp = torch.where(mask_s, torch.linalg.norm(kps_new - st.kps,
                                                         dim=-1), 0.0).amax()
        d_ed = scale_t * max_disp
        r = config.weight_changing_rate
        i_eff = i + st.it_shift
        dwfd = math.exp(-i_eff / r) - math.exp(-(i_eff + 1.0) / r)
        drift_next = d_ed + dwfd * (ed_max + d_ed)
        return _State(
            kps=kps_new, rt=tf.compose(rt_step, st.rt), it=i + 1,
            converged=converged, rms=rmse, fdm=fdm, fdstd=fdstd,
            para1=st.para1 + delta, para2=st.para2 + delta, metrics=m,
            matches=matches, rmse_after=rmse_after, prices=prices,
            acol=acol_new, price_unc=punc_new + drift_next, pen_prev=penalty,
            it_shift=st.it_shift)

    body.warm_kernel_args = warm_kernel_args
    return body


def final_resolve(state: _State, kp_t, mask_s, mask_t, fd,
                  bbx_magnitude: float, config: GHICPConfig):
    """One full-budget KM re-solve at the final pose, at the absolute
    ``km_eps``, deduplicated to one row per column.  Returns (matches [S],
    n_matches, rmse)."""
    dev = kp_t.device
    scale = _f32(config.scale_factor * _f32(bbx_magnitude))
    S, T = state.kps.shape[0], kp_t.shape[0]
    it_eff = _f32(max(state.it - 1, 0) + state.it_shift)
    wed, wfd = blend_weights(it_eff, config)
    ed = euclidean_matrix(state.kps, kp_t, _f(scale, dev))
    cd = torch.where(mask_s[:, None] & mask_t[None, :],
                     _f(wed, dev) * ed + _f(wfd, dev) * fd.to(torch.float32),
                     torch.inf)
    del ed
    ares = auction_match(cd, state.pen_prev, mask_s, mask_t,
                         eps_final=config.km_eps,
                         max_rounds=config.final_resolve_rounds, rel_eps=0.0,
                         p0=state.prices, price_uncertainty=state.price_unc,
                         n_phases=1,
                         acol0=state.acol, keep_slack_extra=0.0)
    tgt_idx, w = ares.match.tgt_idx, ares.match.w
    rows = torch.arange(S, device=dev)
    own = torch.full((T + 1,), -1, dtype=torch.int64, device=dev)
    own.scatter_reduce_(0, torch.where(w > 0, tgt_idx, T), rows, "amax")
    keep1 = (w > 0) & (own[tgt_idx] == rows)
    w1 = keep1.to(torch.float32)
    matches = torch.where(keep1, tgt_idx, -1)
    n = torch.clamp(w1.sum(), min=1.0)
    se = (w1 * ((state.kps - kp_t[tgt_idx]) ** 2).sum(dim=-1)).sum()
    return matches, int(w1.sum()), torch.sqrt(se / n)


def ghicp_register_chunked(kp_s, mask_s, kp_t, mask_t, fd,
                           bbx_magnitude: float, config: GHICPConfig,
                           init_transform=None, it_shift: float = 0.0,
                           device=None, iteration_callback=None
                           ) -> GHICPResult:
    """Run the GH-ICP loop to convergence (or ``max_iterations``), then
    the one-to-one final resolve.  Inputs are moved to ``device`` (the
    card by default).  ``iteration_callback(it, kps, matches)`` gets host
    numpy copies after every iteration."""
    dev = resolve_device(device)
    to = lambda x: torch.as_tensor(x).to(dev)
    kp_s, kp_t = to(kp_s).to(torch.float32), to(kp_t).to(torch.float32)
    mask_s, mask_t = to(mask_s).to(torch.bool), to(mask_t).to(torch.bool)
    fd = to(fd).to(torch.float32)
    T0 = None if init_transform is None else to(init_transform)
    bbx = float(bbx_magnitude)
    state = initial_state(kp_s, kp_t.shape[0], config, T0, it_shift)
    body = make_body(kp_t, mask_s, mask_t, fd, bbx, config)
    while not state.converged and state.it < config.max_iterations:
        state = body(state)
        if iteration_callback is not None:
            iteration_callback(state.it, state.kps.cpu().numpy(),
                               state.matches.cpu().numpy())
    matches = state.matches
    final_rmse = float(state.rmse_after)
    if config.final_resolve_rounds > 0:
        matches, _, rmse = final_resolve(state, kp_t, mask_s, mask_t, fd, bbx,
                                         config)
        final_rmse = float(rmse)
    return GHICPResult(transform=state.rt, iterations=state.it,
                       converged=state.converged,
                       success=final_rmse < 1.5 * config.non_max_radius,
                       final_rmse=final_rmse, metrics=state.metrics,
                       matches=matches)
