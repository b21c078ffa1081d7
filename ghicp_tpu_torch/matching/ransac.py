"""Feature-guided RANSAC coarse alignment, all hypotheses at once.

1. candidates: the ``n_cand`` feature-nearest target keypoints per source
   keypoint (from the dense FD matrix, or given precomputed, as the
   streaming lane does);
2. hypotheses: random triples of candidate pairs (a ``torch.Generator``
   draw) that pass a rigidity and non-degeneracy prefilter, plus, when LCS
   frames are given, one pose per (source row, candidate, sign class) from
   the two local frames;
3. score: every hypothesis is applied to a fixed subsample of source rows
   and scored by the rows whose nearest candidate lands within 2 tau;
4. polish: the 64 best are refit on their inliers at 3, 1.5 and 1 tau, the
   best consensus is refit twice over the full candidate list.

The JAX package draws with ``jax.random``, so the two packages draw
different hypotheses from the same inputs; their poses agree, their
triples do not.  Rotations come from a batched SVD with the det-sign
repair (no power iteration).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ghicp_tpu_torch.core import trace
from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.registration.estimator import kabsch_6dof

BIG = 3.0e38
SCORE_CHUNK = 8192
N_TOP = 64
SVD_BATCH = 32768    # bounds cuSOLVER's batched solver calls


class RansacResult(NamedTuple):
    transform: torch.Tensor    # [4, 4] source -> target
    inliers: int               # consensus size of the best hypothesis
    n_candidates: int          # source rows with a valid first candidate


def rigid_from_cross(M: torch.Tensor, cs: torch.Tensor,
                     cd: torch.Tensor) -> torch.Tensor:
    """Batched rigid transforms [H, 4, 4] from cross-covariances
    M = sum w (s - cs)(d - cd)^T [H, 3, 3] and centroids [H, 3]."""
    parts = [torch.linalg.svd(m) for m in torch.split(M, SVD_BATCH)]
    U = torch.cat([p[0] for p in parts])
    Vh = torch.cat([p[2] for p in parts])
    V = Vh.transpose(1, 2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    d = torch.where(d == 0, torch.ones_like(d), d)
    D = torch.ones_like(cs)
    D[:, 2] = d
    R = (V * D[:, None, :]) @ U.transpose(1, 2)
    t = cd - torch.einsum("hij,hj->hi", R, cs)
    T = torch.zeros((M.shape[0], 4, 4), dtype=M.dtype, device=M.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def _rigid_from_triples(src, dst):
    cs = src.mean(dim=1)
    cd = dst.mean(dim=1)
    M = torch.einsum("hki,hkj->hij", src - cs[:, None], dst - cd[:, None])
    return rigid_from_cross(M, cs, cd)


def _nearest(p, dst, cok):
    """Nearest valid candidate per row under the current poses.
    p [..., M, 3]; dst [M, C, 3]; cok [M, C] -> (d2 [..., M],
    sel [..., M, 3])."""
    d2 = sel = None
    for c in range(dst.shape[1]):
        d2c = ((p - dst[:, c, :]) ** 2).sum(dim=-1)
        d2c = torch.where(cok[:, c], d2c, BIG)
        if d2 is None:
            d2, sel = d2c, dst[:, c, :].expand_as(p)
        else:
            better = d2c < d2
            sel = torch.where(better[..., None], dst[:, c, :], sel)
            d2 = torch.minimum(d2, d2c)
    return d2, sel


def ransac_coarse_align(kp_s, mask_s, kp_t, mask_t, fd, tau: float,
                        n_hyp: int = 1 << 17, n_cand: int = 2, seed: int = 0,
                        frames_s: Optional[torch.Tensor] = None,
                        frames_t: Optional[torch.Tensor] = None,
                        cand: Optional[torch.Tensor] = None,
                        cand_ok: Optional[torch.Tensor] = None
                        ) -> RansacResult:
    """Coarse rigid transform from feature correspondences.  ``fd`` [S, T]
    is a feature distance (smaller = more similar); with ``fd`` None the
    candidates come precomputed as ``cand`` [S, n] target ids and
    ``cand_ok`` [S, n].  ``tau`` is the inlier radius in meters."""
    S = kp_s.shape[0]
    dev = kp_s.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cand is None:
        fdm = torch.where(mask_s[:, None] & mask_t[None, :], fd, BIG)
        neg, cand = torch.topk(-fdm, n_cand, dim=1)          # [S, C]
        cand_ok = (-neg < BIG) & mask_s[:, None]
    else:
        n_cand = cand.shape[1]
    dst_all = kp_t[cand]                                     # [S, C, 3]
    row_ok = cand_ok.any(dim=1)

    # random triples over the top-2 candidates
    rows = torch.randint(0, S, (n_hyp, 3), generator=gen, device=dev)
    cols = torch.randint(0, min(2, n_cand), (n_hyp, 3), generator=gen,
                         device=dev)
    s3 = kp_s[rows]
    t3 = kp_t[cand[rows, cols]]
    ok = cand_ok[rows, cols].all(dim=1)
    ok &= ((rows[:, 0] != rows[:, 1]) & (rows[:, 0] != rows[:, 2])
           & (rows[:, 1] != rows[:, 2]))

    def plen(p):
        return torch.stack([torch.linalg.norm(p[:, 0] - p[:, 1], dim=-1),
                            torch.linalg.norm(p[:, 0] - p[:, 2], dim=-1),
                            torch.linalg.norm(p[:, 1] - p[:, 2], dim=-1)], 1)

    ok &= (torch.abs(plen(s3) - plen(t3)) < 2.0 * tau).all(dim=1)
    e1 = s3[:, 1] - s3[:, 0]
    e2 = s3[:, 2] - s3[:, 0]
    area2 = torch.linalg.norm(torch.linalg.cross(e1, e2), dim=-1)
    base = torch.clamp(torch.linalg.norm(e1, dim=-1), min=1e-6)
    ok &= (area2 / base) > tau
    Ts = _rigid_from_triples(s3, t3)

    if frames_s is not None and frames_t is not None:
        # one pose per (row, candidate, sign class): R = Rt^T D Rs
        Dm = torch.tensor([[1, 1, 1], [-1, -1, 1], [1, -1, -1], [-1, 1, -1]],
                          dtype=torch.float32, device=dev)
        Rt_sel = frames_t[cand]                              # [S, C, 3, 3]
        Rh = torch.einsum("scji,vj,sjl->scvil", Rt_sel, Dm, frames_s)
        th = kp_t[cand][:, :, None, :] - torch.einsum("scvij,sj->scvi", Rh,
                                                      kp_s)
        HF = S * n_cand * 4
        Tf = torch.zeros((HF, 4, 4), dtype=torch.float32, device=dev)
        Tf[:, :3, :3] = Rh.reshape(HF, 3, 3)
        Tf[:, :3, 3] = th.reshape(HF, 3)
        Tf[:, 3, 3] = 1.0
        Ts = torch.cat([Ts, Tf])
        ok = torch.cat([ok, cand_ok.reshape(-1).repeat_interleave(4)])

    # score on a fixed subsample of source rows, hypotheses in chunks
    M = min(2048, S)
    sub = torch.randperm(S, generator=gen, device=dev)[:M]
    sub_src, sub_dst = kp_s[sub], dst_all[sub]
    sub_cok, sub_ok = cand_ok[sub], row_ok[sub]
    tc2 = (2.0 * tau) ** 2
    scores = []
    for h in range(0, Ts.shape[0], SCORE_CHUNK):
        Tc = Ts[h:h + SCORE_CHUNK]
        proj = (torch.einsum("hij,mj->hmi", Tc[:, :3, :3], sub_src)
                + Tc[:, None, :3, 3])
        d2, _ = _nearest(proj, sub_dst, sub_cok)
        scores.append(((d2 < tc2) & sub_ok[None, :]).sum(dim=1))
    score = torch.where(ok, torch.cat(scores), 0)

    _, top = torch.topk(score, min(N_TOP, score.shape[0]))
    Tk = Ts[top]

    def refit(Tc, tau_r):
        p = torch.einsum("kij,mj->kmi", Tc[:, :3, :3], sub_src) \
            + Tc[:, None, :3, 3]
        d2, sel = _nearest(p, sub_dst, sub_cok)
        w = ((d2 < tau_r * tau_r) & sub_ok[None]).to(torch.float32)
        wsum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-6)
        cs = (w @ sub_src) / wsum
        cd = torch.einsum("km,kmi->ki", w, sel) / wsum
        X = sub_src[None] - cs[:, None]
        Y = sel - cd[:, None]
        return rigid_from_cross(torch.einsum("km,kmi,kmj->kij", w, X, Y), cs,
                                cd)

    for tau_r in (3.0 * tau, 1.5 * tau, tau):
        Tk = refit(Tk, tau_r)
    pk = torch.einsum("kij,mj->kmi", Tk[:, :3, :3], sub_src) \
        + Tk[:, None, :3, 3]
    d2k, _ = _nearest(pk, sub_dst, sub_cok)
    inl_k = ((d2k < tau * tau) & sub_ok[None]).sum(dim=1)
    T_best = Tk[torch.argmax(inl_k)]

    for _ in range(2):
        d2, sel = _nearest(tf.apply(T_best, kp_s), dst_all, cand_ok)
        w = ((d2 < tau * tau) & row_ok).to(torch.float32)
        T_best = kabsch_6dof(kp_s, sel, w)
    d2f, _ = _nearest(tf.apply(T_best, kp_s), dst_all, cand_ok)
    final_inl = trace.read(int, ((d2f < tau * tau) & row_ok).sum())
    return RansacResult(transform=T_best, inliers=final_inl,
                        n_candidates=trace.read(int, cand_ok[:, 0].sum()))
