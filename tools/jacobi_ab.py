#!/usr/bin/env python3
"""Time K7 and K8 (the Jacobi auction rounds, ``csrc/jacobi.cu``) on the
card, for one checkout of the repository, so that two trees can be
compared in turns within one call (parent, change, change, parent).

    python3 tools/jacobi_ab.py --root DIR [--label NAME] [--out FILE.jsonl]

``DIR`` is the checkout whose ``ghicp_tpu_torch`` and ``chip_smoke.py``
are imported (this script's own tree by default).  It prints one JSON line
a measurement (and appends it to ``--out`` when given), the card's name and
power limit first:

- ``jacobi``: K7 (``auction_rounds``), K7-f32, K8 (``auction_phase``) and
  K8-f32 from a cold start on two inputs at 8192^2, each the same in every
  tree: (a) K1's bf16 and float32 benefits of ``chip_smoke.py`` phase 2
  (``registration_problem(8192, 8192, seed=7)``, the engine's epsilon and
  sink from K1's statistics; K7 16 rounds, K8 to its exit), and (b) the
  many-round matrix (uniform(-4, 0), a tenth of the pairs at -3e38, numpy
  seed 19, epsilon 0.002, sink -2; K8 to its exit, K7 as many rounds).
  Each: the call (CUDA events around the wrapper) and the kernel alone
  (``chip_smoke.kernel_ms``) in ms, the rounds, ms a round, whether the
  outputs equal the plain version's (on (b) at 64 rounds) and a digest of
  the outputs, the same in both trees where both are right.
"""
import argparse
import hashlib
import json
import os
import sys

SIZE = 8192
MANY_SEED, MANY_EPS, MANY_SINK, MANY_HELD = 19, 0.002, -2.0, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from ghicp_tpu_torch.core.config import GHICPConfig
    from ghicp_tpu_torch.io.synthetic import registration_problem
    from ghicp_tpu_torch.ops.auction_rounds import (auction_phase,
                                                    auction_phase_plain,
                                                    auction_rounds,
                                                    auction_rounds_plain)
    from ghicp_tpu_torch.ops.cost_kernel import CostTarget, fused_benefit
    if not torch.cuda.is_available():
        print("jacobi_ab: no CUDA device", file=sys.stderr)
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
    dev = torch.device("cuda")

    # (a): phase 2's K1 benefits and the engine's epsilon and sink
    rng = np.random.default_rng(7)
    src, tgt, fd_np, _, _, _ = registration_problem(SIZE, SIZE, seed=7)
    pr = cs.k1_problem(torch, src, tgt, fd_np, rng, dev)
    cfg = GHICPConfig()
    wfd = float(np.exp(np.float32(-2.0) / np.float32(6.0)))
    ben = {}
    for bf16 in (True, False):
        fd = pr["fd"].to(torch.bfloat16 if bf16 else torch.float32)
        ben[bf16] = fused_benefit(
            pr["kps_c"], pr["kpt_c"], fd, pr["ms"], pr["mt"], 1.0 - wfd,
            wfd, cfg.scale_factor * 40.0, p_defl=pr["p"], acol0=pr["acol0"],
            with_stats=True, mult_blend=False,
            target=CostTarget(pr["kpt_c"], pr["mt"]))
    eps_a, sink_a = cs.k2_knobs(cfg, ben[True])[:2]
    inputs = {"(a)": (ben[True][0], ben[False][0], eps_a, sink_a)}
    del ben, pr
    # (b): the many-round matrix
    mrng = np.random.default_rng(MANY_SEED)
    m = mrng.uniform(-4, 0, (SIZE, SIZE)).astype(np.float32)
    m[mrng.random((SIZE, SIZE)) < 0.10] = -3e38
    m32 = torch.from_numpy(m).to(dev)
    del m
    inputs["(b)"] = (m32.to(torch.bfloat16), m32, MANY_EPS, MANY_SINK)
    cold = (torch.zeros(SIZE, device=dev),
            torch.full((SIZE,), -1, dtype=torch.int32, device=dev),
            torch.zeros(SIZE, dtype=torch.int32, device=dev))

    def digest(out) -> str:
        h = hashlib.sha1()
        for x in out[:3]:
            h.update(x.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def same(A, B) -> bool:
        return bool(torch.equal(A[0].view(torch.int32),
                                B[0].view(torch.int32))
                    and torch.equal(A[1], B[1]) and torch.equal(A[2], B[2]))

    for inp, (b16, b32, eps, sink) in inputs.items():
        for name, b, phase in (("K7", b16, False), ("K7-f32", b32, False),
                               ("K8", b16, True), ("K8-f32", b32, True)):
            exit_rounds = int(auction_phase(b, *cold, eps, sink, 4000)[3])
            n = 4000 if phase else (16 if inp == "(a)" else exit_rounds)
            kern = auction_phase if phase else auction_rounds
            plain = auction_phase_plain if phase else auction_rounds_plain
            held = n if inp == "(a)" else MANY_HELD
            A, B = kern(b, *cold, eps, sink, held), \
                plain(b, *cold, eps, sink, held)
            equal = same(A, B) and (not phase or int(A[3]) == int(B[3]))
            out = kern(b, *cold, eps, sink, n)
            rounds = int(out[3]) if phase else n
            call = lambda: kern(b, *cold, eps, sink, n)
            ms, k_ms = cs.time_ms(torch, call), cs.kernel_ms(torch, call)
            emit(dict(kind="jacobi", kernel=name, input=inp, S=SIZE, C=SIZE,
                      eps=eps, sink=sink, rounds=rounds, ms=ms,
                      kernel_ms=k_ms, round_ms=k_ms / max(rounds, 1),
                      equal=equal, held_rounds=held, digest=digest(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
