"""BSC descriptors and the Hamming feature distance; FPFH and RoPS
descriptors and their similarity matrices."""
from ghicp_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "bsc": ("BSCFeatures", "bsc_frames", "extract_bsc", "pack_bits",
            "sample_pattern", "unpack_bits", "variant_permutations"),
    "fpfh": ("fpfh_features", "fpfh_similarity_matrix"),
    "hamming": ("hamming_matrix_mxu", "hamming_matrix_popcount",
                "min_hamming_fd"),
    "rops": ("RoPSFeatures", "rops_features", "rops_similarity_matrix"),
})
