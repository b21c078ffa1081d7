"""Voxel filter, radius neighbors, neighborhood PCA and keypoints."""
from ghicp_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "voxel": ("voxel_downsample", "voxel_keys"),
    "neighbors": ("HashGrid", "NeighborList", "build_grid",
                  "radius_neighbors"),
    "pca": ("PCAFeatures", "pca_features", "pca_from_neighbors"),
    "keypoints": ("KeypointResult", "adaptive_detect", "detect_keypoints",
                  "non_max_suppression", "prune_unstable"),
})
