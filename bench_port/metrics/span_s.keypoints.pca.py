"""span_s.keypoints.pca: seconds a pair in the PCA of both clouds
(``pca_features_pair``, its reads included), ``timings["keypoints.pca"]``,
the mean over the window's pairs that carry the key."""
import statistics


def read(rec):
    vals = [p["timings"]["keypoints.pca"] for p in rec["pairs"]
            if "keypoints.pca" in p["timings"]]
    return statistics.fmean(vals) if vals else None
