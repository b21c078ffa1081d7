#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size
on the card: the compared numbers of each registered pair for the sound
program, for the control (the program with its own nearest-neighbour
matching in place of KM, which breaks the configuration's one-to-one
guarantee), for the planted faults (``bench_port/faults.py``) and for the
program with engine settings changed (a second witness of a reading).

    python3 bench_port/control.py --workload <cell> [<cell> ...] \
        [--scene-seeds 1 2 3 ...] [--sides program control \
        fault:half_unmatched engine:auction_bf16=false ...] \
        [--few-scenes 11 12 ...] [--seed 5]

Each side's run registers every scene of the pool once at the least,
through the window's own call (``run.run_cell``).  ``--scene-seeds``
widens the pool beyond the traffic's scenes; faults and engine settings
run on ``--few-scenes`` (by default the traffic's own).  One JSON line a judged pair on
standard output, with ``match_true`` also at other distances
(``truth_at``, in voxels) and ``kp_close`` at other shares of the NMS
radius (``close_at``).  The benchmark's runs do not run it;
``tests/test_bench_port_card.py`` holds the control on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import faults
import run

from reference import check

TRUTH_VOXELS = (1.0, 2.0, 3.0)
CLOSE_SHARES = (0.125, 0.25, 0.5)


def side_spec(spec: dict, side: str) -> dict:
    """The cell's spec for ``side``: ``control``, ``engine:k=v,k=v`` (JSON
    values) or the program as it is."""
    if side == "control":
        over = {"correspondence": "nn"}
    elif side.startswith("engine:"):
        over = {k: json.loads(v) for k, v in (
            kv.split("=", 1) for kv in side[len("engine:"):].split(","))}
    else:
        return spec
    return dict(spec, config=dict(spec["config"], engine={
        **spec["config"]["engine"], **over}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--scene-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    ap.add_argument("--few-scenes", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    pools, refs = {}, {}

    def log(m):
        print(m, file=sys.stderr, flush=True)
    for cell in args.workload:
        spec = run.cell_spec(root, cell)
        scenes = list(dict.fromkeys(spec["traffic"]["scene_seeds"]
                                    + args.scene_seeds))
        few_scenes = args.few_scenes or spec["traffic"]["scene_seeds"]
        key = json.dumps(spec["config"]["scene"], sort_keys=True)
        pool = pools.setdefault(key, {})
        for s in scenes + few_scenes:
            if s not in pool:
                pool[s] = (s, *run.gen.make_pair(spec["config"]["scene"], s))
        for side in args.sides:
            fault = side[len("fault:"):] if side.startswith("fault:") else None
            few = fault or side.startswith("engine:")
            use = few_scenes if few else scenes
            sub = [pool[s] for s in use]

            def on_judged(k, out, got, side=side, sub=sub, spec=spec):
                cfg = run.engine_config(spec)
                ref = refs[(sub[k][0], cfg.voxel_size,
                            spec["config"]["name"])]
                truth = {str(v): ref.match_true(out, v)
                         for v in TRUTH_VOXELS}
                close = {str(f): check.close_share(
                    [out["keypoints_source"], out["keypoints_target"]],
                    f * cfg.non_max_radius) for f in CLOSE_SHARES}
                print(json.dumps({
                    "cell": cell, "side": side, "scene": sub[k][0],
                    "got": got, "truth_at": truth, "close_at": close,
                    "matched": int((out["matches"] >= 0).sum()),
                    "keypoints": [len(out["keypoints_source"]),
                                  len(out["keypoints_target"])]}),
                      flush=True)
            ctx = faults.planted(fault) if fault else contextlib.nullcontext()
            with ctx, contextlib.redirect_stdout(sys.stderr):
                got = run.run_cell(side_spec(spec, side), args.seed, 0.0,
                                   False, pool=sub, min_pairs=len(sub),
                                   refs=refs, on_judged=_to_stdout(on_judged),
                                   log=log)
            print(json.dumps({"cell": cell, "side": side, "run": True,
                              "correct": got["correct"],
                              "attempted": got["attempted"],
                              "checks": got["checks"]}), flush=True)
    return 0


def _to_stdout(fn):
    """``fn`` with standard output restored (the run's own goes to
    standard error)."""
    def call(*a):
        with contextlib.redirect_stdout(sys.__stdout__):
            fn(*a)
    return call


if __name__ == "__main__":
    sys.exit(main())
