"""Row-sharded GH-ICP: the source keypoints' rows split over the ranks of
a ``torch.distributed`` process group.

The port of the JAX package's ``shard/spmd.py``.  There one program runs
over a mesh axis (``shard_map``); here each rank is one process running
the same engine (:mod:`ghicp_tpu_torch.registration.ghicp`) on its rows,
with every cross-row reduction going through the
:class:`~ghicp_tpu_torch.core.comm.Comm` (the CD statistics, the auction's
bid and owner resolution, the Kabsch sums, the convergence inputs):

* every rank gets the global inputs and takes rows [r S / P, (r + 1) S /
  P) of the source keypoints, their mask and the FD (or the source
  factors); target keypoints, mask and prices stay whole on every rank;
* :func:`ghicp_register_sharded` covers the dense lanes (the kernel lane:
  K1 and K2 on the rank's rows, the sharded Gauss-Seidel auction; the XLA
  lane: the sharded Jacobi rounds, K6 on the rank's rows) and, with
  ``stream``, the streaming lane (K5 on the rank's rows);
* :func:`ghicp_register_ring` is the BSC + KM ring: the target's factor
  rows are split too, block r on rank r, and each sweep passes the blocks
  around the ring (``ops/stream_kernel.py::ring_sweep``).

Replicated outputs (transform, iterations, metrics) are equal on every
rank; ``matches`` is all-gathered into the global [S].  No final matching
runs, as in the JAX package's sharded entry points.  Each rank runs on its
card, ``cuda:{LOCAL_RANK % device_count}`` (:func:`rank_device`), unless
``device`` says otherwise.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ghicp_tpu_torch.core.comm import Comm, rows_of
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.ops.stream_kernel import (StreamFeatures, ring_features,
                                               subset_rows)
from ghicp_tpu_torch.registration.ghicp import GHICPResult, _loop


def rank_device(local_rank: Optional[int] = None) -> torch.device:
    """This rank's card: ``cuda:{local_rank % device_count}``, the local
    rank from ``LOCAL_RANK`` by default; raises without a card."""
    resolve_device("cuda")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _device(device) -> torch.device:
    return rank_device() if device is None else resolve_device(device)


def _result(state, matches, config: GHICPConfig) -> GHICPResult:
    return GHICPResult(
        transform=state.rt, iterations=state.it, converged=state.converged,
        success=float(state.rmse_after) < 1.5 * config.non_max_radius,
        final_rmse=float(state.rmse_after), metrics=state.metrics,
        matches=matches)


def ghicp_register_sharded(kp_s, mask_s, kp_t, mask_t, fd, bbx_magnitude,
                           config: GHICPConfig, comm: Comm, stream=None,
                           init_transform=None, it_shift: float = 0.0,
                           device=None) -> GHICPResult:
    """Row-sharded GH-ICP over ``comm``'s ranks (global inputs on every
    rank; S must be a multiple of the rank count).  ``stream`` (``fd``
    None): the streaming lane, its source factor rows sharded."""
    S = len(kp_s)
    rows = rows_of(comm, S)
    if stream is not None:
        fd, stream = None, subset_rows(stream, rows)
    else:
        fd = fd[rows]
    state = _loop(kp_s[rows], mask_s[rows], kp_t, mask_t, fd,
                  bbx_magnitude, config, init_transform, it_shift,
                  _device(device), None, stream, comm, S)[0]
    return _result(state, comm.all_gather(state.matches), config)


def ghicp_register_ring(kp_s, mask_s, kp_t, mask_t, stream: StreamFeatures,
                        bbx_magnitude, config: GHICPConfig, comm: Comm,
                        init_transform=None, it_shift: float = 0.0,
                        device=None) -> GHICPResult:
    """The ring-sharded streaming GH-ICP (BSC + KM): source rows and the
    target's factor blocks both split over the ranks, the blocks rotating
    once around the ring each sweep; coordinates, popcounts, masks,
    prices and the packed target words stay whole on every rank."""
    S, C = len(kp_s), len(kp_t)
    n = comm.axis_size()
    if S % n or C % n:
        raise ValueError(f"row / column counts ({S}, {C}) not divisible by "
                         f"{n} ranks")
    rows = rows_of(comm, S)
    ring = ring_features(stream, rows, comm.axis_index(), n)
    state = _loop(kp_s[rows], mask_s[rows], kp_t, mask_t, None,
                  bbx_magnitude, config, init_transform, it_shift,
                  _device(device), None, ring, comm, S)[0]
    return _result(state, comm.all_gather(state.matches), config)
