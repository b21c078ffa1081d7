#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch port (``ghicp_tpu_torch``).

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell's entry in ``BENCHMARK.json`` names its configuration
(``bench_port/configs/<config>.json``: the scene, the engine's settings,
the pose limits it states) and its traffic
(``bench_port/traffic/<traffic>.json``: the pool's scene seeds and the
settings the traffic changes); the limits set from the cell's readings
are ``bench_port/limits/<cell>.json``; each metric is read by
``bench_port/metrics/<metric>.py``.  Nothing here names a
cell, a configuration or a metric: a new one is new files and a new entry.

Set-up: the port's CUDA libraries are built (or found built) in the
package's ``_build/``, the pool's pairs are made on the host while nvcc
runs, and the pool's first pair is registered once (the traffic fixes the
keypoint slots, so every pair brings the same kernel shapes).  The
window: one closed-loop client calls ``register_pair`` on the pool's
pairs, in cycles whose order the seed draws, until ``--seconds`` have
passed; each pair is timed on the host clock.  With ``--trace 1`` one more cycle runs under
``torch.profiler`` after the window, for the device's share and kernel
times.  Then the plain reference (``bench_port/reference/``) judges every
pair the window and the traced cycle registered, and the last line of
standard output is the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import enum  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import gen  # noqa: E402
import devtrace  # noqa: E402
from reference import check  # noqa: E402

# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package (``ghicp_tpu_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "ghicp_tpu")


class RunError(Exception):
    """A run that cannot give a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: Path, workload: str) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    metrics that apply to it, from ``BENCHMARK.json`` at ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    limits = HERE / "limits" / f"{workload}.json"
    if not limits.is_file():
        raise RunError(f"no limits file for {workload!r}")
    return {"cell": cell,
            "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(limits),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """``read(rec)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def engine_config(spec: dict):
    """The port's ``GHICPConfig`` from the configuration's ``engine``
    block with the traffic's settings over it (enum fields by value)."""
    from ghicp_tpu_torch.core.config import GHICPConfig
    fields = {f.name: f for f in dataclasses.fields(GHICPConfig)}
    values = {**spec["config"]["engine"], **spec["traffic"]["engine"]}
    kw = {}
    for k, v in values.items():
        if k not in fields:
            raise RunError(f"GHICPConfig has no field {k!r}")
        default = fields[k].default
        kw[k] = type(default)(v) if isinstance(default, enum.Enum) else v
    return GHICPConfig(**kw)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_outputs(out) -> dict:
    """What the reference judges of one registration, as host arrays."""
    import numpy as np
    kp_s = out.keypoints_source
    return {"transform": np.asarray(out.transform),
            "matches": out.result.matches.cpu().numpy()[:len(kp_s)],
            "keypoints_source": kp_s,
            "keypoints_target": out.keypoints_target,
            "n_down": (out.n_source_down, out.n_target_down)}


def launches_since(before: dict, now: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", log=print, pool=None, min_pairs: int = 0,
             refs=None, on_judged=None) -> dict:
    """Set-up, the window, the traced cycle and the check of one run;
    returns the result's fields (``checks`` last).  For a process that
    runs several: ``pool``, the traffic's pairs made already
    (``gen.make_pool``); ``min_pairs``, pairs the window registers at the
    least; ``refs``, a dict that keeps each scene's reference;
    ``on_judged(k, out, got)``, called with each judged pair."""
    import torch

    on_card = device == "cuda"
    from ghicp_tpu_torch.ops import LAUNCHES, _build
    from ghicp_tpu_torch.registration import pipeline

    cfg = engine_config(spec)
    traffic = spec["traffic"]
    given, pool = pool, []

    def make_pool():
        pool.extend(given or gen.make_pool(spec["config"]["scene"],
                                           traffic["scene_seeds"]))
    if on_card:
        # the port keeps its libraries and Triton's cache in its ignored
        # _build/ inside the checkout, a fixed path: only a checkout's first
        # run builds
        _build.triton_cache()
        _build.build_all(while_building=make_pool)
    else:
        make_pool()
    if not pool:
        raise RunError("the traffic names no scene")

    def register(k):
        _, src, tgt, _ = pool[k]
        return pipeline.register_pair(src, tgt, cfg, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()
    register(0)
    sync()
    setup_s = time.perf_counter() - T_START

    order = gen.visits(len(pool), seed)
    pairs, judged = [], []
    t0 = time.perf_counter()
    while True:
        k = next(order)
        before = dict(LAUNCHES)
        a = time.perf_counter()
        out = register(k)
        b = time.perf_counter()
        judged.append((k, host_outputs(out)))
        pairs.append({"pool": k, "wall_s": b - a,
                      "timings": dict(out.timings),
                      "iterations": int(out.result.iterations),
                      "launches": launches_since(before, LAUNCHES)})
        del out
        if b - t0 >= seconds and len(pairs) >= min_pairs:
            break
    window_s = b - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        cycle = [next(order) for _ in range(len(pool))]
        with profile(activities=acts) as prof:
            with record_function("bench.slice"):
                for k in cycle:
                    with record_function("bench.pair"):
                        out = register(k)
                    judged.append((k, host_outputs(out)))
                    del out
                sync()
        ev = devtrace.events(prof)
        sl = [(a, b) for n, a, b in ev["host"] if n == "bench.slice"]
        if not sl:
            raise RunError("the trace holds no bench.slice range")
        traced = devtrace.summarize(ev, *sl[0])
        traced["pairs"] = len(cycle)
        del prof, ev

    if on_card:
        torch.cuda.empty_cache()
    # the plain reference, once the window has closed and the program's
    # device state is freed
    voxel = cfg.voxel_size
    refs = {} if refs is None else refs

    def ref(k):
        scene, src, tgt, T_gt = pool[k]
        key = (scene, voxel, spec["config"]["name"])
        if key not in refs:
            refs[key] = check.PairReference(src, tgt, T_gt, voxel)
        return refs[key]
    limits = check.limits(spec["config"]["limits"], spec["limits"])
    worst, failed = {}, 0
    for k, out in judged:
        got = ref(k).judge(out, cfg.non_max_radius)
        if on_judged is not None:
            on_judged(k, out, got)
        if any(check.breaks(n, got[n], limits[n]) for n in limits):
            failed += 1
        for n in limits:
            worst[n] = check.worse(n, worst.get(n, got[n]), got[n])
    correct = bool(judged) and not any(
        check.breaks(n, worst[n], limits[n]) for n in limits)

    rec = {"setup_s": setup_s, "window_s": window_s, "pairs": pairs,
           "trace": traced}
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[section]:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(spec["cell"]["chips"]),
               "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": len(judged),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["checks"] = {
        n: {"value": float(worst[n]), "limit": limits[n],
            "fails": "below" if n in check.FLOORS else "above"}
        for n in limits}
    log(f"pairs {len(pairs)} in {window_s:.3f} s, set-up {setup_s:.3f} s, "
        f"pool scene seeds {[p[0] for p in pool]}")
    log("pair walls (pool index, s): " + " ".join(
        f"{p['pool']}:{p['wall_s']:.4f}" for p in pairs))
    for n in limits:
        side = "at least" if n in check.FLOORS else "at most"
        log(f"check {n} {worst[n]!r} limit {side} {limits[n]!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    root = Path.cwd()
    try:
        spec = cell_spec(root, args.workload)
        import torch
        chips = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA device(s); "
                           f"{torch.cuda.device_count()} available")
        if str(root) not in sys.path:
            sys.path.insert(0, str(root))
        with contextlib.redirect_stdout(sys.stderr):
            result = run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), log=log)
    except RunError as e:
        log(f"no result: {e}")
        return 2
    found = forbidden_loaded()
    if found:
        log(f"no result: modules loaded in this process: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
