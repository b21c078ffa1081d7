"""Cold-start warm-up of the PyTorch port.

A fresh checkout builds its libraries at first use: every CUDA kernel
source with nvcc and the native host runtime with g++, into the package's
``_build/``.  This tool builds them all at once (one nvcc per source,
started together), then runs one registration of a synthetic pair at the
deployment's expected scale, so the first real run finds every library
built.  It prints the build seconds and the registration seconds.

Usage:
  python -m ghicp_tpu_torch.cli.warmup --points 800000 --feature B \\
      --corres K --voxel 0.1 --radius 0.5 --nms 0.5
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ghicp_tpu_torch import native
from ghicp_tpu_torch.cli.main import CORRES, FEATURE
from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.core.device import resolve_device
from ghicp_tpu_torch.io.synthetic import structured_scene
from ghicp_tpu_torch.ops import _build
from ghicp_tpu_torch.registration.pipeline import register_pair


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="build the port's libraries and run one registration "
                    "at a given scale")
    p.add_argument("--points", type=int, default=800_000)
    p.add_argument("--extent", type=float, default=25.0)
    p.add_argument("--feature", choices=list("BFRN"), default="B")
    p.add_argument("--corres", choices=list("KNR"), default="K")
    p.add_argument("--voxel", type=float, default=0.1)
    p.add_argument("--radius", type=float, default=0.5)
    p.add_argument("--nms", type=float, default=0.5)
    p.add_argument("--dof", type=int, choices=[4, 6], default=6)
    p.add_argument("--streaming", choices=["auto", "on", "off"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' builds the "
                        "native runtime only)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    libs = _build.build_all() if dev.type == "cuda" else []
    native.build()
    t_build = time.perf_counter() - t0

    cfg = GHICPConfig(feature=FeatureType(FEATURE[args.feature]),
                      correspondence=CorrespondenceType(CORRES[args.corres]),
                      reg_dof=args.dof, voxel_size=args.voxel,
                      neighborhood_radius=args.radius,
                      non_max_radius=args.nms,
                      streaming_cost=args.streaming)
    rng = np.random.default_rng(0)
    pts = structured_scene(rng, args.points, extent=args.extent)
    theta = np.deg2rad(8.0)
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    src = ((pts - np.float32([0.8, -0.5, 0.1])) @ R
           + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    tgt = (pts + rng.normal(0, 0.006, pts.shape)).astype(np.float32)
    t0 = time.perf_counter()
    out = register_pair(src, tgt, cfg, device=dev)
    t_reg = time.perf_counter() - t0
    print(f"[warmup] built {len(libs)} CUDA libraries and the native "
          f"runtime in {t_build:.1f}s; ran the {args.points}-pt "
          f"{args.feature}/{args.corres} pipeline on {dev} in {t_reg:.1f}s "
          f"(kps={out.n_source_keypoints}/{out.n_target_keypoints})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
