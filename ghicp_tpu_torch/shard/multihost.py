"""Multi-process orchestration: the process group and pair-parallel graphs.

The port of the JAX package's ``shard/multihost.py``.  Two axes scale the
engine: within a pair (rows split over the ranks,
:mod:`ghicp_tpu_torch.shard.spmd`) and across pairs (here): a station
graph's pairs are dealt round-robin over the processes, each process
builds only the stations its pairs touch, runs the single-pair engine on
its pairs and the transforms and qualities are exchanged in one
all-gather at the end.  One process runs :func:`register_graph` as it is.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ghicp_tpu_torch.core.comm import LOCAL, Comm, check_nccl
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.registration.graph import _poses_from_mst_static


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: str = "nccl") -> int:
    """Initialise the default process group from the arguments or from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); returns the process count.
    Without either it does nothing and returns 1; once initialised it
    returns the group's size.  ``backend`` is the caller's choice: NCCL
    (one GPU a rank; raises without enough cards) or gloo.  Any other
    failure raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if init_method is None:
        return 1
    world_size = (int(env.get("WORLD_SIZE", "1")) if world_size is None
                  else world_size)
    rank = int(env.get("RANK", "0")) if rank is None else rank
    if backend == "nccl":
        check_nccl(world_size)
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    elif backend != "gloo":
        raise ValueError(f"init_distributed: backend {backend!r} (nccl or "
                         "gloo)")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return world_size


def world_comm() -> Comm:
    """The default group's :class:`Comm`, or ``LOCAL`` without one."""
    import torch.distributed as dist
    return Comm.world() if dist.is_initialized() else LOCAL


def partition_pairs(pairs: Sequence[Tuple[int, int]], process_id: int,
                    process_count: int) -> List[Tuple[int, int]]:
    """Round-robin pair partition: static, deterministic, balanced for
    pairs of one keypoint capacity."""
    return [p for i, p in enumerate(pairs) if i % process_count == process_id]


def register_graph_distributed(clouds: Sequence[np.ndarray],
                               pairs: Sequence[Tuple[int, int]],
                               config: GHICPConfig,
                               keypoint_capacity: Optional[int] = None,
                               comm: Optional[Comm] = None, device=None):
    """Station-graph registration with the pairs dealt over ``comm``'s
    ranks (the default group's by default).  Every rank returns the whole
    result: (per-pair transforms [P, 4, 4] in pair order, qualities [P],
    station poses); the spanning-tree chaining runs on every rank from the
    gathered transforms.  Each rank runs on its card
    (``shard.spmd.rank_device``) unless ``device`` says otherwise."""
    from ghicp_tpu_torch.core.device import resolve_device
    from ghicp_tpu_torch.registration.ghicp import ghicp_register
    from ghicp_tpu_torch.registration.graph import (_coarse_init_pair,
                                                    build_station,
                                                    register_graph,
                                                    station_pair_fd)
    from ghicp_tpu_torch.shard.spmd import rank_device
    comm = world_comm() if comm is None else comm
    dev = rank_device() if device is None else resolve_device(device)
    pc, pid = comm.axis_size(), comm.axis_index()
    if pc == 1:
        results, poses = register_graph(clouds, pairs, config,
                                        keypoint_capacity, device=dev)
        tfs = (np.stack([r.transform for r in results]) if results
               else np.zeros((0, 4, 4), np.float32))
        quals = np.array([r.quality for r in results], np.float32)
        return tfs, quals, poses
    cap = keypoint_capacity or config.keypoint_capacity or 2048
    mine = [(i, p) for i, p in enumerate(pairs) if i % pc == pid]
    needed = sorted({k for _, (s, t) in mine for k in (s, t)})
    stations = {i: build_station(clouds[i], i, config, cap, dev)
                for i in needed}
    # one row a pair: 16 transform entries and the quality; each rank
    # fills its pairs' rows, the gathered blocks add up (the others zero)
    buf = torch.zeros((len(pairs), 17), dtype=torch.float32, device=dev)
    for gi, (si, ti) in mine:
        s, t = stations[si], stations[ti]
        fd = station_pair_fd(s, t, config)
        T0, it_shift = _coarse_init_pair(s, t, fd, config)
        res = ghicp_register(s.kp_xyz, s.kp_mask, t.kp_xyz, t.kp_mask, fd,
                             s.bbx_magnitude, config, init_transform=T0,
                             it_shift=it_shift, device=dev)
        it = max(int(res.iterations) - 1, 0)
        buf[gi, :16] = res.transform.reshape(-1)
        buf[gi, 16] = res.metrics.iou[it]
    got = comm.all_gather(buf).reshape(pc, len(pairs), 17).sum(dim=0)
    got = got.cpu().numpy()
    tfs = got[:, :16].reshape(-1, 4, 4).astype(np.float32)
    quals = got[:, 16].astype(np.float32)
    return tfs, quals, _poses_from_mst_static(len(clouds), list(pairs), tfs,
                                              quals)
