"""Command-line driver of the PyTorch port: the ``ghicp`` binary's interface.

Takes the reference's 13 positional arguments (test/ghicp_main.cpp:56-78,
script/run.sh:21-24), so existing run scripts port directly:

  ghicp <targetT> <sourceS> <outputR> <feature B|F|R|N> <corres K|N|R>
        <voxel_size> <neighborhood_radius> <non_max_radius>
        <weight_adjust_ratio> <weight_adjust_step> <dof 4|6>
        <estimated_overlap> <launch_viewer 0|1>

and the JAX package's named flags (``ghicp_tpu/cli/main.py``), with the
same printed lines, files and return codes (0 on success, 2 on failure).
There is no viewer: ``launch_viewer=1`` exports the registered pair as
PLY files next to the output.  It runs on the card; ``--device cpu``
runs the plain PyTorch versions on the host.  Not taken: ``--jax-cache``
(the kernels are built once into the package's ``_build/``).
``--distributed`` initialises the process group from torchrun's
environment (``shard/multihost.py::init_distributed``; backend
``--backend``, by default NCCL on the card and gloo with ``--device
cpu``) and prints ``[distributed] N process(es), M device(s)``; then, as
the JAX command line does, every process registers the pair, each on its
own card (``cuda:{LOCAL_RANK % device_count}``), and prints its result;
rank 0 alone writes the files.

Usage:  python -m ghicp_tpu_torch.cli.main <13 args> [flags]   (-h)
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.io.files import read_cloud, write_cloud
from ghicp_tpu_torch.registration.pipeline import register_pair

FEATURE = {"B": "bsc", "F": "fpfh", "R": "rops", "N": "none"}
CORRES = {"K": "km", "N": "nn", "R": "nnr"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ghicp",
        description="GH-ICP pairwise point cloud registration on a GPU")
    p.add_argument("target", help="target cloud (.pcd/.las/.ply/.txt)")
    p.add_argument("source", help="source cloud to be transformed")
    p.add_argument("output", help="registered source output path")
    p.add_argument("feature", choices=list("BFRN"),
                   help="B=BSC F=FPFH R=RoPS N=none")
    p.add_argument("corres", choices=list("KNR"),
                   help="K=global-optimal (auction/KM) N=NN R=reciprocal NN")
    p.add_argument("voxel_size", type=float)
    p.add_argument("neighborhood_radius", type=float)
    p.add_argument("non_max_radius", type=float)
    p.add_argument("weight_adjust_ratio", type=float)
    p.add_argument("weight_adjust_step", type=float)
    p.add_argument("dof", type=int, choices=[4, 6])
    p.add_argument("estimated_overlap", type=float)
    p.add_argument("viewer", type=int, choices=[0, 1],
                   help="1 = also export PLY files of the aligned pair")
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--coarse-init", choices=["ransac", "none"],
                   default="ransac",
                   help="coarse initialization ('none' = the reference's "
                        "identity start)")
    p.add_argument("--ransac-hypotheses", type=int, default=None,
                   help="RANSAC hypothesis sweep width (default: config)")
    p.add_argument("--save-keypoints", metavar="BASE", default=None,
                   help="write detected keypoint coordinates to "
                        "BASE_keypoints_source.txt / BASE_keypoints_target"
                        ".txt (the savecoordinates surface, "
                        "dataio.hpp:609-626)")
    p.add_argument("--save-correspondences", metavar="PATH", default=None,
                   help="write the final matched pairs to PATH: one line "
                        "per pair 'src_row tgt_col sx sy sz tx ty tz' with "
                        "registered source coordinates (the Corres.txt "
                        "surface, km.cpp:144-162); a .npz PATH stores "
                        "arrays (rows, cols, src_xyz, tgt_xyz) instead")
    p.add_argument("--export-every-k", type=int, metavar="K", default=0,
                   help="export the MOVING source keypoints and the current "
                        "correspondences every K engine iterations as "
                        "OUTPUT_iterNNN_source.txt / _corres.txt (the "
                        "reference's per-iteration viewer refresh and "
                        "Corres.txt dumps, cloud_viewer.hpp:165-249, "
                        "km.cpp:148)")
    p.add_argument("--json", action="store_true",
                   help="print a single JSON result line")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions on the host)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed from torchrun's "
                        "environment (MASTER_ADDR / MASTER_PORT / "
                        "WORLD_SIZE / RANK / LOCAL_RANK) before running")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend under --distributed "
                        "(default: nccl, gloo with --device cpu)")
    return p


def config_from_args(args: argparse.Namespace) -> GHICPConfig:
    """The registration's config from parsed arguments; ``engine_chunk``
    is the snapshot cadence where ``--export-every-k`` is set."""
    return GHICPConfig(
        feature=FeatureType(FEATURE[args.feature]),
        correspondence=CorrespondenceType(CORRES[args.corres]),
        reg_dof=args.dof,
        estimated_overlap=args.estimated_overlap,
        voxel_size=args.voxel_size,
        neighborhood_radius=args.neighborhood_radius,
        non_max_radius=args.non_max_radius,
        weight_adjustment_ratio=args.weight_adjust_ratio,
        weight_adjustment_step=args.weight_adjust_step,
        max_iterations=args.max_iterations,
        coarse_init=args.coarse_init,
        **({"ransac_hypotheses": args.ransac_hypotheses}
           if args.ransac_hypotheses else {}),
        **({"engine_chunk": args.export_every_k}
           if args.export_every_k > 0 else {}))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    device, writer = args.device, True
    if args.distributed:
        from ghicp_tpu_torch.shard import init_distributed, rank_device
        cpu = device == "cpu"
        backend = args.backend or ("gloo" if cpu else "nccl")
        n_proc = init_distributed(backend=backend)
        if device is None:
            device = rank_device()
        n_dev = 1 if cpu else min(n_proc, torch.cuda.device_count())
        print(f"[distributed] {n_proc} process(es), {n_dev} device(s)")
        if n_proc > 1:
            import torch.distributed as dist
            writer = dist.get_rank() == 0

    t0 = time.perf_counter()
    tgt, _ = read_cloud(args.target)
    src, shift_s = read_cloud(args.source)
    print(f"[io] target {len(tgt)} pts, source {len(src)} pts "
          f"({time.perf_counter() - t0:.1f}s)")

    snapshots = []
    cb = None
    if args.export_every_k > 0:
        # snapshots are written after the run: the valid keypoint count
        # and the target coordinates are known only then
        cb = lambda it, kps, matches: snapshots.append((it, kps, matches))

    out = register_pair(src, tgt, config, iteration_callback=cb,
                        device=device)
    it = int(out.result.iterations)
    m = out.result.metrics
    cor, rmse, iou, pen = (np.asarray(x.cpu()) for x in (
        m.cor, m.rmse, m.iou, m.penalty))
    for i in range(it):
        print(f"[iter {i:3d}] cor={int(cor[i])} rmse={float(rmse[i]):.4f} "
              f"iou={float(iou[i]):.3f} penalty={float(pen[i]):.3f}")
    verdict = "Succeed" if out.success else "Failed"
    print(f"[result] Registration {verdict}. iterations={it} "
          f"final_rmse={out.final_rmse:.4f} "
          f"keypoints={out.n_source_keypoints}/{out.n_target_keypoints}")
    print("[transform]")
    print(np.array2string(out.transform, precision=6, suppress_small=False))

    registered = src @ out.transform[:3, :3].T + out.transform[:3, 3]
    if writer:
        _write(args, out, src, tgt, shift_s, registered, snapshots)

    if args.json:
        print(json.dumps({
            "success": bool(out.success), "iterations": it,
            "final_rmse": out.final_rmse,
            "transform": out.transform.tolist(),
            "timings": out.timings}))
    if args.distributed:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0 if out.success else 2


def _write(args, out, src, tgt, shift_s, registered, snapshots) -> None:
    """The run's files: the registered cloud and every asked-for export."""
    write_cloud(args.output, registered, global_shift=shift_s)
    print(f"[io] wrote {args.output}")

    if args.save_keypoints:
        np.savetxt(args.save_keypoints + "_keypoints_source.txt",
                   out.keypoints_source, fmt="%.6f")
        np.savetxt(args.save_keypoints + "_keypoints_target.txt",
                   out.keypoints_target, fmt="%.6f")
        print(f"[io] wrote {args.save_keypoints}_keypoints_*.txt "
              f"({len(out.keypoints_source)}/{len(out.keypoints_target)} "
              f"keypoints)")

    if args.save_correspondences:
        corres = out.final_correspondences()
        if args.save_correspondences.endswith(".npz"):
            np.savez(args.save_correspondences,
                     rows=corres[:, 0].astype(np.int32),
                     cols=corres[:, 1].astype(np.int32),
                     src_xyz=corres[:, 2:5].astype(np.float32),
                     tgt_xyz=corres[:, 5:8].astype(np.float32))
        else:
            np.savetxt(args.save_correspondences, corres,
                       fmt="%d %d %.6f %.6f %.6f %.6f %.6f %.6f")
        print(f"[io] wrote {args.save_correspondences} "
              f"({len(corres)} correspondences)")

    if snapshots:
        base = args.output.rsplit(".", 1)[0]
        ns = len(out.keypoints_source)
        kp_t = out.keypoints_target
        for it_k, kps, matches in snapshots:
            np.savetxt(f"{base}_iter{it_k:03d}_source.txt", kps[:ns],
                       fmt="%.6f")
            rows = np.nonzero(matches[:ns] >= 0)[0]
            cols = matches[rows]
            corres = np.column_stack([rows, cols, kps[rows], kp_t[cols]])
            np.savetxt(f"{base}_iter{it_k:03d}_corres.txt", corres,
                       fmt="%d %d %.6f %.6f %.6f %.6f %.6f %.6f")
        print(f"[io] wrote {len(snapshots)} intermediate-state snapshot(s) "
              f"({base}_iterNNN_source.txt / _corres.txt)")

    if args.viewer:
        base = args.output.rsplit(".", 1)[0]
        write_cloud(base + "_pair_source.ply", registered)
        write_cloud(base + "_pair_target.ply", tgt)
        print(f"[viewer] exported {base}_pair_*.ply")


if __name__ == "__main__":
    sys.exit(main())
