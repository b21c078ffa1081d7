"""Exact-radius non-max suppression fixed point (kernel K4), CUDA C++ in
``csrc/nms.cu``, with its plain PyTorch version.

Replaces ``ghicp_tpu/ops/nms_kernel.py::nms_pallas`` (Pallas
``_nms_kernel``).  Per round, a candidate wins iff it is alive and beats
(curvature desc, original index asc) every alive candidate within the
radius; winners are selected and suppress their alive neighbours; the
rounds end when nothing is alive.  The fixed point is the serial greedy-by-
curvature selection, with an exact radius (no neighbour cap).

Distances are direct differences of coordinates centred on the candidate
centroid, ``(dx*dx + dy*dy) + dz*dz`` compared with ``r*r``, in the kernel
and in the plain version alike, so the two agree bit for bit (the TPU
kernel's norm expansion may flip pairs that lie exactly on the radius).

:func:`nms_prep` is the host-side set-up of the kernel, as ``_nms_prep``
in the JAX package: centre, Morton-sort (invalid rows last), cut tiles of
256, list for each row tile the column tiles whose bounding boxes lie
within the radius, and flatten those (row tile, column tile) pairs into
the kernel's work items.  Bound on this card: operations, the distance
tests of the alive pairs in near tiles; the design notes are at the head
of the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ghicp_tpu_torch.core import trace
from ghicp_tpu_torch.ops import count_launch, require_device

TS = 256                 # candidates a tile (the kernel's block size)
_PAIR_CHUNK = 1 << 24    # distance entries a chunk of the plain version
_BIG = 2**62


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so consecutive bits are 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _r2(radius) -> torch.Tensor:
    return torch.tensor(float(radius), dtype=torch.float32) ** 2


def _centred(xyz: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Coordinates centred on the candidate centroid (0 at non-candidates)."""
    nc = torch.clamp(cand.to(torch.float32).sum(), min=1.0)
    center = torch.where(cand[:, None], xyz, 0.0).sum(dim=0) / nc
    return torch.where(cand[:, None], xyz - center[None, :], 0.0)


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, B] squared distances by direct differences, in the kernel's
    order (each difference, product and sum rounded in float32)."""
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    dz = a[:, None, 2] - b[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


class NMSPrep(NamedTuple):
    xc: torch.Tensor        # [N, 4] sorted (x, y, z, curvature), centred
    oid: torch.Tensor       # [N] int32 original index of each sorted row
    cand: torch.Tensor      # [N] int32 sorted candidate flags
    nbr_cnt: torch.Tensor   # [T] int32 near column tiles of each row tile
    nbr_idx: torch.Tensor   # [T, maxn] int32 their ids (ascending)
    items: torch.Tensor     # [T * maxn] int32 work items k * T + t (the
                            # k-th near tile of row tile t), listed first
    n_items: torch.Tensor   # [1] int32 listed items (on the device)
    r2: float               # radius^2 rounded to float32


def nms_prep(xyz, curv, cand, radius, ts: int = TS) -> NMSPrep:
    """Centre, Morton-sort, tile, list the near tiles and flatten them
    into work items (one host read: the largest near count, which sizes
    the table)."""
    N = curv.shape[0]
    T = N // ts
    cand = cand.to(torch.bool)
    r2 = _r2(radius).to(xyz.device)
    x = _centred(xyz.to(torch.float32), cand)
    mn = torch.where(cand[:, None], x, 3e38).amin(dim=0)
    mx = torch.where(cand[:, None], x, -3e38).amax(dim=0)
    q = torch.clamp((mx - mn).amax(), min=1e-6) / 1023.0
    ig = torch.clamp((x - mn[None, :]) / q, 0.0, 1023.0).to(torch.int64)
    code = (_spread3(ig[:, 0]) | (_spread3(ig[:, 1]) << 1)
            | (_spread3(ig[:, 2]) << 2))
    code = torch.where(cand, code, 2**31 - 1)
    order = torch.sort(code, stable=True).indices
    xs, cd = x[order], cand[order]
    xt = xs.view(T, ts, 3)
    vt = cd.view(T, ts, 1)
    tmn = torch.where(vt, xt, 3e38).amin(dim=1)
    tmx = torch.where(vt, xt, -3e38).amax(dim=1)
    gap = torch.maximum(tmn[:, None, :] - tmx[None, :, :],
                        tmn[None, :, :] - tmx[:, None, :])
    gap = torch.clamp(gap, min=0.0, max=1e19)
    # same association as the pair distances, so the tile test never
    # drops a pair within the radius
    d2t = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]
    near = d2t <= r2
    nbr_cnt = near.sum(dim=1).to(torch.int32)
    maxn = max(trace.read(int, nbr_cnt.max()), 1)
    nbr_idx = torch.sort((~near).to(torch.int8), dim=1, stable=True).indices
    # items k-major (code k * T + t), so that blocks taking consecutive
    # items work on different row tiles; the listed ones first
    listed = (torch.arange(maxn, device=xyz.device)[None, :]
              < nbr_cnt[:, None]).T.reshape(-1)
    items = torch.sort((~listed).to(torch.int8), stable=True).indices
    xc = torch.cat([xs, curv.to(torch.float32)[order][:, None]], dim=1)
    return NMSPrep(xc=xc.contiguous(), oid=order.to(torch.int32),
                   cand=cd.to(torch.int32),
                   nbr_cnt=nbr_cnt.contiguous(),
                   nbr_idx=nbr_idx[:, :maxn].to(torch.int32).contiguous(),
                   items=items.to(torch.int32).contiguous(),
                   n_items=listed.sum().to(torch.int32).reshape(1),
                   r2=float(r2))


def within_pairs(x: torch.Tensor, cand: torch.Tensor, r2: torch.Tensor):
    """(i, j) index pairs of distinct candidates within the radius, from
    direct differences in row chunks."""
    N = x.shape[0]
    idx = torch.nonzero(cand).flatten()
    xc = x[idx]
    n = idx.shape[0]
    rows = max(1, _PAIR_CHUNK // max(n, 1))
    ii, jj = [], []
    for a in range(0, n, rows):
        d2 = _d2(xc[a:a + rows], xc)
        hit = d2 <= r2
        hit[torch.arange(hit.shape[0], device=x.device),
            torch.arange(a, a + hit.shape[0], device=x.device)] = False
        i, j = torch.nonzero(hit, as_tuple=True)
        ii.append(idx[i + a])
        jj.append(idx[j])
    if not ii:
        e = torch.zeros((0,), dtype=torch.int64, device=x.device)
        return e, e
    return torch.cat(ii), torch.cat(jj)


def nms_exact_plain(xyz, curv, cand, radius, max_rounds: int = 128,
                    on_round=None):
    """Plain PyTorch version of K4: the same fixed point over the sparse
    list of within-radius candidate pairs (built once, O(block * N)
    memory).  ``on_round(alive, wins)``, if given, sees each round's alive
    and winning candidates.  Returns (selected [N] bool, rounds)."""
    N = curv.shape[0]
    dev = xyz.device
    cand = cand.to(torch.bool)
    curv = curv.to(torch.float32)
    x = _centred(xyz.to(torch.float32), cand)
    pi, pj = within_pairs(x, cand, _r2(radius).to(dev))
    idx = torch.arange(N, device=dev)
    alive, sel, rounds = cand.clone(), torch.zeros_like(cand), 0
    neg = torch.full((N,), float("-inf"), dtype=torch.float32, device=dev)
    big = torch.full((N,), _BIG, dtype=torch.int64, device=dev)
    while rounds < max_rounds and trace.read(bool, alive.any()):
        aj = alive[pj]
        cj = torch.where(aj, curv[pj], float("-inf"))
        maxc = neg.scatter_reduce(0, pi, cj, "amax")
        at = aj & (cj == maxc[pi])
        idmin = big.scatter_reduce(0, pi, torch.where(at, pj, _BIG), "amin")
        wins = alive & ((curv > maxc) | ((curv == maxc) & (idx < idmin)))
        if on_round is not None:
            on_round(alive, wins)
        sel = sel | wins
        supp = torch.zeros((N,), dtype=torch.bool, device=dev)
        supp[pi[wins[pj]]] = True
        alive = alive & ~wins & ~supp
        rounds += 1
    return sel, rounds


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from ghicp_tpu_torch.ops._build import cuda_library
    lib = cuda_library("nms")
    if not getattr(lib, "_typed", False):
        lib.nms_exact.argtypes = ([_VP] * 6 + [_I] * 4 + [_F]
                                  + [_VP] * 5)
        lib.nms_exact.restype = _I
        lib._typed = True
    return lib


def nms_exact_cuda(prep: NMSPrep, max_rounds: int = 128):
    """Launch K4 on the card.  Returns (selected [N] bool in the original
    order, rounds [1] int32 on the card).  Counts the launch under
    ``nms_exact`` and ``nms_exact@<N>``."""
    from ghicp_tpu_torch.ops._build import check, ptr
    N = prep.oid.shape[0]
    T = N // TS
    dev = prep.xc.device
    i32 = torch.int32
    state = torch.empty((N,), dtype=i32, device=dev)
    sel = torch.empty((N,), dtype=i32, device=dev)
    # round r's losers at 2 r + 1, its suppressed at 2 r + 2
    cnt = torch.zeros((2 * int(max_rounds) + 1,), dtype=i32, device=dev)
    rounds = torch.zeros((1,), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().nms_exact(ptr(prep.xc), ptr(prep.oid), ptr(prep.cand),
                          ptr(prep.nbr_idx), ptr(prep.items),
                          ptr(prep.n_items), N, T, prep.nbr_idx.shape[1],
                          int(max_rounds), prep.r2, ptr(state), ptr(cnt),
                          ptr(sel), ptr(rounds), _VP(stream))
    check(rc, "nms_exact launch")
    count_launch("nms_exact")
    count_launch(f"nms_exact@{N}")
    out = torch.zeros((N,), dtype=torch.bool, device=dev)
    out[prep.oid.long()] = sel > 0
    return out, rounds


def nms_exact(xyz, curv, cand, radius, max_rounds: int = 128):
    """Exact-radius greedy-equivalent NMS, the whole fixed point in one
    launch on the card (the plain version for CPU tensors).  xyz [N, 3],
    curv [N], cand [N] bool with N % 256 == 0.  Returns (selected [N]
    bool, rounds int)."""
    N = curv.shape[0]
    if N % TS:
        raise ValueError(f"nms_exact: N={N} is not a multiple of {TS}")
    if require_device(xyz, "nms_exact") == "cuda":
        prep = nms_prep(xyz, curv, cand, radius)
        sel, rounds = nms_exact_cuda(prep, max_rounds)
        return sel, trace.read(int, rounds)
    return nms_exact_plain(xyz, curv, cand, radius, max_rounds)
