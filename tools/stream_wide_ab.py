#!/usr/bin/env python3
"""Time K5 past four variants and configuration 7 on the card, for one
checkout of the repository, so that two trees can be compared in turns
within one call (parent, change, change, parent).

    python3 tools/stream_wide_ab.py --root DIR [--label NAME]
        [--repeats 3] [--out FILE.jsonl]

``DIR`` is the checkout whose ``ghicp_tpu_torch`` and ``chip_smoke.py``
are imported (this script's own tree by default).  It builds that tree's
kernels, then prints one JSON line a measurement (and appends it to
``--out`` when given):

- ``sweep``: the Hamming-lane K5 sweep (``stream_sweep``) on random
  inputs from a fixed seed, the same in every tree: V = 12 and 6 at 8192^2,
  4096^2 and on a 2048-row block against 4096 columns (config 7's
  streaming shapes), V = 12 with the column side at 8192^2, V = 3, 5, 16,
  20 and 28 on the 2048-row block; and V = 4 (``ham_kernel``, which the
  change leaves as it was) at 51,200^2, on a 2048-row block of it and with
  the column side at 8192^2.  Each case: the call and the kernel alone
  (``chip_smoke.kernel_ms``), with and without the statistics, in ms, and
  whether its top-2, vsel and count equal the plain version's (the V = 4
  51,200^2 case is not compared: its plain sweep takes seconds);
- ``config7``: ``register_pair`` on configuration 7 (``chip_smoke.
  config7_pair``, ``bsc_offsets=3``), dense and streaming, ``--repeats``
  times each after one warm-up: the register stage's seconds, iterations,
  rotation and translation error and the pose;
- the card's name and power limit first.
"""
import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from ghicp_tpu_torch.features.bsc import pack_bits
    from ghicp_tpu_torch.matching.auction import SINK
    from ghicp_tpu_torch.ops import _build
    from ghicp_tpu_torch.ops.stream_kernel import (make_stream_features,
                                                   stream_sweep,
                                                   stream_sweep_plain,
                                                   subset_rows, sweep_target)
    from ghicp_tpu_torch.registration.pipeline import (register_pair,
                                                       transform_error)
    if not torch.cuda.is_available():
        print("stream_wide_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)

    def emit(rec: dict) -> None:
        rec = dict(label=args.label, root=root, **rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    emit(dict(kind="card", card=cs.card_line()))
    t0 = time.perf_counter()
    _build.build_all()
    emit(dict(kind="build", seconds=time.perf_counter() - t0))
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    t = lambda x, **k: torch.tensor(x, device=dev, **k)

    def problem(V, S, C):
        kp_s = t(rng.uniform(-20, 20, (S, 3)), dtype=torch.float32)
        kp_t = t(rng.uniform(-20, 20, (C, 3)), dtype=torch.float32)
        ms, mt = t(rng.random(S) < 0.95), t(rng.random(C) < 0.95)
        prices = t(rng.uniform(0, 3, C), dtype=torch.float32)
        acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S), -1)
        acol[::13] = SINK
        feats = make_stream_features(
            pack_bits(t(rng.random((V, S, 441)) < 0.3).to(torch.int64)),
            pack_bits(t(rng.random((1, C, 441)) < 0.3).to(torch.int64)))
        return (kp_s, kp_t, feats, ms, mt, prices, t(acol), 0.7, 0.3, 0.3)

    def block(a, rows):
        idx = torch.arange(0, a[0].shape[0], a[0].shape[0] // rows,
                           device=dev)[:rows]
        return (a[0][idx], a[1], subset_rows(a[2], idx), a[3][idx], a[4],
                a[5], a[6][idx]) + a[7:]

    def sweep_case(V, a, col=False, compare=True):
        tg = sweep_target(a[1], a[2], a[4])
        rec = dict(kind="sweep", V=V, rows=a[0].shape[0],
                   cols=a[1].shape[0], col=col)
        if compare:
            A = stream_sweep(*a, col_side=col, target=tg)
            B = stream_sweep_plain(*a, col_side=col)
            same = cs.same_top2(torch, A, B) and float(A.cnt) == float(B.cnt)
            if col:
                same = same and torch.equal(A.cmin, B.cmin) and torch.equal(
                    A.crow, B.crow)
            rec["equal"] = bool(same)
        call = lambda: stream_sweep(*a, col_side=col, target=tg)
        rec.update(ms=cs.time_ms(torch, call),
                   kernel_ms=cs.kernel_ms(torch, call))
        if not col:
            nocall = lambda: stream_sweep(*a, with_stats=False, target=tg)
            rec.update(ms_no_stats=cs.time_ms(torch, nocall),
                       kernel_ms_no_stats=cs.kernel_ms(torch, nocall))
        emit(rec)

    for V in (12, 6):
        for n in (8192, 4096):
            a = problem(V, n, n)
            sweep_case(V, a)
            if V == 12 and n == 8192:
                sweep_case(V, a, col=True)
            if n == 4096:
                sweep_case(V, block(a, 2048))
            del a
    for V in (3, 5, 16, 20, 28):
        sweep_case(V, block(problem(V, 4096, 4096), 2048))
    a = problem(4, 51200, 51200)
    sweep_case(4, a, compare=False)
    sweep_case(4, block(a, 2048))
    del a
    sweep_case(4, problem(4, 8192, 8192), col=True)

    s7, t7, T7 = cs.config7_pair()
    c7 = cs.config7()
    for lane, mode in (("dense", "off"), ("streaming", "on")):
        cfg = dataclasses.replace(c7, streaming_cost=mode)
        register_pair(s7, t7, cfg)       # warm-up
        for rep in range(args.repeats):
            out = register_pair(s7, t7, cfg)
            rot, tr = transform_error(out.transform, T7)
            emit(dict(kind="config7", lane=lane, rep=rep,
                      register_s=out.timings["register"],
                      iterations=int(out.result.iterations),
                      rot_err=float(rot), t_err=float(tr),
                      pose=np.asarray(out.transform, np.float64).tolist()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
