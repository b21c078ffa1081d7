"""A cell at a size the CPU tests can hold: the cell's own files with a
12,000-point scene and the verdict drive's settings (voxel 0.15 m), and
the limits that the cell's readings set, at that size: on the CPU the
sound run reads kp_close 0.0 and match_true 0.968, a broken suppression
kp_close 0.34, half of the matching left out and a wrong matching
match_true 0.47 and 0.0."""
from pathlib import Path

import run

ROOT = Path(__file__).resolve().parent.parent.parent

SMALL_SCENE = {"kind": "bench_pair", "n_points": 12000, "extent": 10.0,
               "yaw_deg": 20.0, "translation": [1.0, -0.5, 0.2],
               "noise": 0.006}
SMALL_ENGINE = {"voxel_size": 0.15, "min_neighbors": 8,
                "estimated_overlap": 0.9, "max_iterations": 30,
                "pca_max_cells": 0}
SMALL_LIMITS = {"kp_close": 0.1, "match_true": 0.7}


def small_spec(workload: str = "tls_dense.nms1", engine=None) -> dict:
    spec = run.cell_spec(ROOT, workload)
    spec["config"] = dict(spec["config"], scene=SMALL_SCENE,
                          engine={**spec["config"]["engine"],
                                  **SMALL_ENGINE, **(engine or {})})
    spec["traffic"] = dict(spec["traffic"], scene_seeds=[2],
                           engine={"non_max_radius": 1.0})
    spec["limits"] = SMALL_LIMITS
    return spec


def small_run(spec: dict, seed: int = 5, trace: bool = False) -> dict:
    return run.run_cell(spec, seed, 0.0, trace, device="cpu",
                        log=lambda m: None)
