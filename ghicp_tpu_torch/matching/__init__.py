"""Cost matrices, the auction (KM) matcher, NN / NNR matching and RANSAC
coarse alignment."""
from ghicp_tpu_torch._lazy import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "auction": ("AuctionResult", "auction_match"),
    "cost": ("CostResult", "blend_bsc", "blend_fpfh", "blend_none",
             "euclidean_matrix"),
    "matchers": ("MatchResult", "nn_match", "nnr_match"),
})
