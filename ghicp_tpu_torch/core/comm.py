"""Collective-communication context threaded through the engine.

The port's counterpart of the JAX package's ``core/comm.py``: every
cross-row reduction of the engine goes through a :class:`Comm`.  The JAX
package runs one program over a mesh axis (``shard_map``); here each rank
is one process of a ``torch.distributed`` process group, holding its row
shard (or its pairs), and a :class:`Comm` wraps that group.  ``LOCAL``
(no group) is the identity: the same engine code then runs on one device.

The backend is the caller's explicit choice, made when the process group
is initialised (``shard/multihost.py::init_distributed``,
``shard/launch.py``), never by catching a failure:

* ``nccl``: one GPU a rank (the multi-GPU deployment).  A NCCL group
  with more ranks on this host than GPUs raises, and so does a NCCL
  collective given a CPU tensor;
* ``gloo``: CPU tensors (the tests), and ranks that share one card.  There
  a CUDA tensor is copied to the host, reduced there and copied back
  (``staged``): gloo's own CUDA support is partial (no send / receive), so
  the port never relies on it.

Every collective counts its calls, bytes and wall seconds
(:meth:`Comm.stats`), so a run can report the share of its wall spent in
them.  On the card the wall of a collective is taken between two device
synchronisations, so the compute queued before it is not counted.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

_OPS = ("psum", "pmax", "pmin", "ppermute", "all_gather")


def _dist():
    import torch.distributed as dist
    return dist


class _Pending:
    """A ring transfer in flight (:meth:`Comm.ppermute_start`)."""

    def __init__(self, comm, reqs, buf, device, t0: float, nbytes: int):
        self.comm, self.reqs, self.buf = comm, reqs, buf
        self.device, self.t0, self.nbytes = device, t0, nbytes

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        out = self.buf.to(self.device)
        self.comm._count("ppermute", self.nbytes, self.t0, out)
        return out


class _Done:
    def __init__(self, x):
        self.x = x

    def wait(self):
        return self.x


class Comm:
    """Reduction context over the default process group; ``Comm()`` (no
    backend) is the single-device identity, :data:`LOCAL`."""

    def __init__(self, backend: Optional[str] = None):
        self.backend = backend
        self.counts = {k: [0, 0, 0.0] for k in _OPS}
        if backend is None:
            self.rank, self.size = 0, 1
            return
        dist = _dist()
        if not dist.is_initialized():
            raise RuntimeError("Comm: torch.distributed is not initialised "
                               "(shard.multihost.init_distributed or "
                               "shard.launch)")
        got = dist.get_backend()
        if got != backend:
            raise ValueError(f"Comm: the process group's backend is {got}, "
                             f"not {backend}")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"Comm: backend {backend!r} (nccl or gloo)")
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        if backend == "nccl":
            check_nccl(self.size)

    @classmethod
    def world(cls) -> "Comm":
        """The context of the initialised default process group."""
        return cls(_dist().get_backend())

    # ---- the JAX Comm's interface ----
    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (gloo)."""
        return self.backend == "gloo"

    def axis_index(self) -> int:
        return self.rank

    def axis_size(self) -> int:
        return self.size

    def psum(self, x):
        return self._reduce(x, "psum")

    def pmax(self, x):
        return self._reduce(x, "pmax")

    def pmin(self, x):
        return self._reduce(x, "pmin")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on each) concatenated along axis
        0 in rank order."""
        if not self.distributed:
            return x
        dist = _dist()
        t0 = self._begin(x)
        xs = self._stage(x)
        parts = [torch.empty_like(xs) for _ in range(self.size)]
        dist.all_gather(parts, xs)
        out = torch.cat(parts).to(x.device)
        self._count("all_gather", x.numel() * x.element_size() * self.size,
                    t0, out)
        return out

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The ring step: send ``x`` to rank r - shift, return what rank
        r + shift sent (the JAX package's ``perm = [(i, i - 1)]``)."""
        return self.ppermute_start(x, shift).wait()

    def ppermute_start(self, x: torch.Tensor, shift: int = 1):
        """Start :meth:`ppermute`; ``.wait()`` on the result returns the
        received tensor (the caller computes meanwhile)."""
        if not self.distributed or shift % self.size == 0:
            return _Done(x)
        dist = _dist()
        t0 = self._begin(x)
        xs = self._stage(x).contiguous()
        buf = torch.empty_like(xs)
        ops = [dist.P2POp(dist.isend, xs, (self.rank - shift) % self.size),
               dist.P2POp(dist.irecv, buf, (self.rank + shift) % self.size)]
        reqs = dist.batch_isend_irecv(ops)
        return _Pending(self, reqs, buf, x.device, t0,
                        x.numel() * x.element_size())

    # ---- counters ----
    def stats(self) -> dict:
        """{op: (calls, bytes, seconds)} and the totals under "all"."""
        out = {k: tuple(v) for k, v in self.counts.items()}
        out["all"] = tuple(sum(v[i] for v in self.counts.values())
                           for i in range(3))
        return out

    def reset_stats(self) -> None:
        for v in self.counts.values():
            v[:] = [0, 0, 0.0]

    # ---- internals ----
    def _check(self, x: torch.Tensor) -> None:
        if self.backend == "nccl" and x.device.type != "cuda":
            raise ValueError(f"Comm(nccl): a {x.device.type} tensor; NCCL "
                             "reduces CUDA tensors only")

    def _begin(self, x: torch.Tensor) -> float:
        self._check(x)
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.staged and x.device.type == "cuda" else x

    def _count(self, op: str, nbytes: int, t0: float, out) -> None:
        if torch.is_tensor(out) and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        c = self.counts[op]
        c[0] += 1
        c[1] += int(nbytes)
        c[2] += time.perf_counter() - t0

    def _reduce(self, x, op: str):
        if not self.distributed:
            return x
        dist = _dist()
        x = torch.as_tensor(x)
        t0 = self._begin(x)
        y = self._stage(x).clone()
        dist.all_reduce(y, {"psum": dist.ReduceOp.SUM,
                            "pmax": dist.ReduceOp.MAX,
                            "pmin": dist.ReduceOp.MIN}[op])
        y = y.to(x.device)
        self._count(op, x.numel() * x.element_size(), t0, y)
        return y


def check_nccl(world_size: int) -> None:
    """Raise unless NCCL can give each of this host's ranks its own GPU:
    a card is present and the host's ranks (``LOCAL_WORLD_SIZE``, else the
    world size) do not outnumber its GPUs."""
    if not torch.cuda.is_available():
        raise RuntimeError("nccl: no CUDA device on this host (gloo is a "
                           "choice of the caller, not a fallback)")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    n = torch.cuda.device_count()
    if local > n:
        raise RuntimeError(f"nccl: {local} ranks on this host and {n} "
                           f"GPU(s); NCCL puts one rank on a GPU (ranks "
                           f"sharing a card take gloo)")


LOCAL = Comm()


def rows_of(comm: Comm, n: int) -> slice:
    """This rank's block of ``n`` rows: [r n / P, (r + 1) n / P); raises
    unless P divides ``n``."""
    P = comm.axis_size()
    if n % P:
        raise ValueError(f"row count {n} not divisible by {P} ranks")
    k = n // P
    return slice(comm.axis_index() * k, (comm.axis_index() + 1) * k)
