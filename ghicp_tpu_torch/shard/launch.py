"""Run a task, or a command, as P processes of one process group.

The port's counterpart of the JAX package's 8-device virtual mesh (the
tests' ``make_mesh``) and of ``tools/multihost_smoke.py``: each rank is one
child process.

    python -m ghicp_tpu_torch.shard.launch --ranks 4 --backend gloo \\
        [--device cpu] [--timeout 600] [--payload args.pkl] <task>
    python -m ghicp_tpu_torch.shard.launch --ranks 2 -- <command ...>

A task is a name of :data:`ghicp_tpu_torch.shard.tasks.TASKS` or
``module:function``; each child calls ``function(comm, **payload)`` with
its :class:`~ghicp_tpu_torch.core.comm.Comm` and the pickled payload, and
its return value comes back to :func:`launch` in rank order.  The children
meet through a ``FileStore`` in a temporary directory, so launches running
side by side (parallel test workers) never race for a port.  A command runs
under torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) on a free
local port: the command line's ``--distributed`` reads it.

Every child has the launch's timeout.  One failed rank kills the others
and fails the launch with that rank's output tail; so does a rank that
outlives the timeout (a rank that took another branch than the others
waits in a collective forever).  A child never imports JAX: each checks
before it exits that neither ``jax`` nor the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

_ROOT = Path(__file__).resolve().parents[2]
TAIL = 4000   # bytes of a failed rank's output in the error


def _tail(path: Path) -> str:
    try:
        return path.read_bytes()[-TAIL:].decode(errors="replace")
    except OSError:
        return ""


def _env(threads: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def _run(cmds: Sequence[list], envs: Sequence[dict], work: Path,
         timeout: float) -> list:
    """Start every rank, wait for all; on a failure or the timeout kill the
    rest and raise with the failed rank's output.  Returns the outputs."""
    logs = [work / f"rank{r}.log" for r in range(len(cmds))]
    procs = []
    try:
        for cmd, env, log in zip(cmds, envs, logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=str(_ROOT), stdout=f,
                    stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        failed = {}     # rank: (exit code, when it was seen)
        while True:
            rcs = [p.poll() for p in procs]
            now = time.monotonic()
            for r, rc in enumerate(rcs):
                if rc not in (None, 0) and r not in failed:
                    failed[r] = (rc, now)
            if failed and (now - min(t for _, t in failed.values()) > 2.0
                           or all(rc is not None for rc in rcs)):
                # the first rank to fail, with its output; a rank whose
                # peer died fails after it
                order = sorted(failed, key=lambda k: failed[k][1])
                r = order[0]
                rest = "".join(f"\n--- rank {k} exited {failed[k][0]}:\n"
                               f"{_tail(logs[k])[-TAIL // 4:]}"
                               for k in order[1:])
                raise RuntimeError(f"launch: rank {r} of {len(procs)} "
                                   f"exited {failed[r][0]}:\n"
                                   f"{_tail(logs[r])}{rest}")
            if all(rc == 0 for rc in rcs):
                return [log.read_text(errors="replace") for log in logs]
            if time.monotonic() > deadline:
                waiting = [r for r, rc in enumerate(rcs) if rc is None]
                r = waiting[0]
                raise RuntimeError(
                    f"launch: rank(s) {waiting} of {len(procs)} still "
                    f"running after {timeout:.0f} s:\n{_tail(logs[r])}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def launch(task: str, ranks: int, backend: str, payload: Optional[dict] = None,
           timeout: float = 600.0, threads: int = 1,
           quiet: bool = True) -> list:
    """Run ``task`` on ``ranks`` processes over ``backend`` (``nccl`` or
    ``gloo``); returns each rank's result, in rank order."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"launch: backend {backend!r} (nccl or gloo)")
    work = Path(tempfile.mkdtemp(prefix="ghicp_launch_"))
    try:
        pay = work / "payload.pkl"
        with open(pay, "wb") as f:
            pickle.dump(payload or {}, f)
        cmds, envs = [], []
        for r in range(ranks):
            cmds.append([sys.executable, "-m", "ghicp_tpu_torch.shard.launch",
                         "--child", str(r), "--ranks", str(ranks),
                         "--backend", backend, "--store",
                         str(work / "store"), "--payload", str(pay),
                         "--out", str(work / f"out{r}.pkl"),
                         "--threads", str(threads), task])
            env = _env(threads)
            env.update(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks))
            envs.append(env)
        outs = _run(cmds, envs, work, timeout)
        if not quiet:
            for r, o in enumerate(outs):
                for line in o.splitlines():
                    print(f"[rank {r}] {line}")
        results = []
        for r in range(ranks):
            with open(work / f"out{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_command(argv: Sequence[str], ranks: int, timeout: float = 600.0,
                   threads: int = 1) -> list:
    """Run the command ``argv`` as ``ranks`` processes under torchrun's
    environment on a free local port; returns each rank's output (stdout
    and stderr), in rank order."""
    work = Path(tempfile.mkdtemp(prefix="ghicp_launch_"))
    try:
        port = str(free_port())
        envs = []
        for r in range(ranks):
            env = _env(threads)
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       WORLD_SIZE=str(ranks), RANK=str(r),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks))
            envs.append(env)
        return _run([list(argv)] * ranks, envs, work, timeout)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def resolve_task(task: str):
    if ":" in task:
        mod, fn = task.split(":", 1)
        return getattr(importlib.import_module(mod), fn)
    from ghicp_tpu_torch.shard.tasks import TASKS
    if task not in TASKS:
        raise ValueError(f"launch: unknown task {task!r} (one of "
                         f"{sorted(TASKS)}, or module:function)")
    return TASKS[task]


def no_jax_loaded() -> None:
    """Raise if JAX or the JAX package is in this process."""
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "ghicp_tpu" or m.startswith("ghicp_tpu.")]
    if bad:
        raise RuntimeError(f"a rank imported {sorted(bad)[:5]}")


def _child(args) -> int:
    import torch
    import torch.distributed as dist

    from ghicp_tpu_torch.core.comm import Comm, check_nccl
    torch.set_num_threads(args.threads)
    rank, world = args.child, args.ranks
    if args.backend == "nccl":
        check_nccl(world)
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(args.store, world)
    dist.init_process_group(args.backend, store=store, rank=rank,
                            world_size=world)
    try:
        comm = Comm(args.backend)
        with open(args.payload, "rb") as f:
            payload = pickle.load(f)
        result = resolve_task(args.task)(comm, **payload)
        with open(args.out, "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    no_jax_loaded()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ghicp_tpu_torch.shard.launch",
        description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the process group's backend (a task needs it; "
                         "gloo for ranks sharing one card or the CPU)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--threads", type=int, default=1,
                    help="torch threads a rank")
    ap.add_argument("--payload", default=None,
                    help="pickled dict of the task's keyword arguments")
    ap.add_argument("--device", default=None,
                    help="the tasks' device (default: each rank's card)")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("task", nargs=argparse.REMAINDER,
                    help="a task (name or module:function), or -- and a "
                         "command")
    args = ap.parse_args(argv)
    if args.child is not None:
        args.task = args.task[0]
        return _child(args)
    if args.task and args.task[0] == "--":
        outs = launch_command(args.task[1:], args.ranks, args.timeout,
                              args.threads)
        for r, o in enumerate(outs):
            for line in o.splitlines():
                print(f"[rank {r}] {line}")
        return 0
    if len(args.task) != 1 or args.backend is None:
        ap.error("give --backend and one task (or -- and a command)")
    payload = {}
    if args.payload:
        with open(args.payload, "rb") as f:
            payload = pickle.load(f)
    if args.device:
        payload["device"] = args.device
    staged = args.backend == "gloo" and args.device != "cpu"
    print(f"[launch] {args.ranks} rank(s) over {args.backend}"
          + (": ranks sharing the card(s), CUDA tensors staged through "
             "host memory" if staged else ""))
    results = launch(args.task[0], args.ranks, args.backend, payload,
                     args.timeout, args.threads, quiet=False)
    for r, res in enumerate(results):
        print(f"[rank {r}] result: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
