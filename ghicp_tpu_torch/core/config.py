"""Typed configuration of the GH-ICP pipeline (PyTorch port).

An own copy of the reference package's ``GHICPConfig`` and its enums: the
port imports nothing of the JAX package.  Every field is kept, so a config
round-trips between the two packages by field name (``interop.py``); the
few knobs that only steer JAX compilation or TPU kernel dispatch are kept
as inert fields and noted as such.
"""
from __future__ import annotations

import dataclasses
import enum


class FeatureType(enum.Enum):
    """Feature encoding for the hybrid metric."""

    BSC = "bsc"
    FPFH = "fpfh"
    ROPS = "rops"
    NONE = "none"


class CorrespondenceType(enum.Enum):
    """Correspondence solver."""

    KM = "km"    # globally-optimal bipartite matching (auction solver)
    NN = "nn"    # nearest neighbor with penalty gate
    NNR = "nnr"  # reciprocal nearest neighbor


@dataclasses.dataclass(frozen=True)
class GHICPConfig:
    """All tunables of the GH-ICP pipeline (same fields and defaults as the
    JAX package; see its ``core/config.py`` for the measured rationale of
    each default)."""

    # --- pipeline switches ---
    feature: FeatureType = FeatureType.BSC
    correspondence: CorrespondenceType = CorrespondenceType.KM
    reg_dof: int = 6
    estimated_overlap: float = 0.6

    # --- preprocessing ---
    voxel_size: float = 0.1
    neighborhood_radius: float = 0.5
    non_max_radius: float = 1.0
    unstable_ratio_threshold: float = 0.65
    min_neighbors: int = 20
    neighbor_k: int = 128
    pca_cell_cap: int = 64
    pca_max_cells: int = 0
    nms_k: int = 128
    nms_cell_cap: int = 64
    keypoint_capacity: int = 0

    # --- sub-voxel keypoint refinement ---
    refine_keypoints: bool = True
    refine_radius: float = 0.0            # 0 = auto (3 * voxel_size)
    refine_method: str = "centroid"       # only "centroid" is ported
    min_curvature: float = 0.0

    # --- adaptive keypoint target band (not ported yet) ---
    adaptive_keypoints: bool = False
    keypoints_min: int = 5000
    keypoints_max: int = 50000

    # --- BSC feature ---
    bsc_grid_side: int = 7
    bsc_seed: int = 20170417
    bsc_neighbor_k: int = 128
    bsc_radius: float = 0.0               # 0 = non_max_radius
    bsc_offsets: int = 1
    bsc_offset_delta: float = 0.0         # 0 = voxel_size / 2

    # --- FPFH / RoPS features (not ported yet) ---
    fpfh_k: int = 20
    fpfh_radius: float = 0.0
    rops_radius: float = 0.0
    rops_rotations: int = 3
    rops_bins: int = 5
    rops_neighbor_k: int = 256

    # --- energy function ---
    penalty_initial: float = 2.0
    para1_penalty: float = 1.0
    para2_penalty: float = 1.0
    min_cor: int = 10
    weight_changing_rate: float = 6.0
    km_eps: float = 0.01
    scale_factor: float = 0.005

    # --- iteration / convergence ---
    weight_adjustment_ratio: float = 1.1
    weight_adjustment_step: float = 0.1
    converge_translation: float = 0.02
    converge_rotation: float = 0.02
    max_iterations: int = 100
    engine_chunk: int = 64                # inert here: the port's engine is
                                          # a host loop with one read of
                                          # ``converged`` per iteration

    # --- robust transform estimation ---
    confidence_weighting: bool = True
    robust_irls_rounds: int = 2
    robust_trim_c: float = 2.5

    # --- coarse initialization ---
    coarse_init: str = "ransac"           # "ransac" | "none"
    ransac_tau: float = 0.0               # 0 = 3 * voxel_size
    ransac_hypotheses: int = 1 << 17
    ransac_min_inliers: int = 12
    identity_hypotheses: int = 1          # only 1 is ported
    ransac_candidates: int = 4
    ransac_max_rows: int = 8192

    # --- auction solver ---
    auction_max_rounds: int = 2
    auction_warm_rounds: int = 1
    auction_warm_after: float = 8.0
    auction_warm_min_rows: int = 4096
    auction_phases: int = 1
    fused_cost_kernel: bool = True        # False: the XLA lane
    warm_fused_kernel: bool = True
    streaming_cost: str = "auto"
    streaming_threshold: int = 16384
    stream_open_cap: int = 2048
    stream_refresh_every: int = 32
    final_resolve_rounds: int = 3000
    stream_compact_budget: int = 48
    stream_fast_path: bool = True
    auction_rel_eps: float = 1.0 / 64.0

    # --- compile-time behavior (JAX only; inert here) ---
    parallel_compile_warmup: bool = True

    # --- numerics ---
    use_mxu_hamming: bool = True          # inert: FD is always one matmul
    auction_bf16: bool = True
    auction_round_kernel: bool = True     # False: Jacobi rounds (K6), not
                                          # the GS phase kernel

    def __post_init__(self):
        if self.reg_dof not in (4, 6):
            raise ValueError(f"reg_dof must be 4 or 6, got {self.reg_dof}")
        if self.bsc_grid_side < 3:
            raise ValueError("bsc_grid_side must be >= 3")

    @property
    def bsc_num_variants(self) -> int:
        """LCS variants per source keypoint: 4 for 6-DoF, 2 for 4-DoF."""
        return 4 if self.reg_dof == 6 else 2

    @property
    def bsc_grid_bits(self) -> int:
        return 3 * self.bsc_grid_side * self.bsc_grid_side

    @property
    def bsc_compare_bits(self) -> int:
        return 6 * self.bsc_grid_side * self.bsc_grid_side

    @property
    def bsc_total_bits(self) -> int:
        return self.bsc_grid_bits + self.bsc_compare_bits
