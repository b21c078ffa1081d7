"""span_s.keypoints.refine: seconds a pair in both clouds' sub-voxel
refinement (the pruning survivors compacted, then the mean shift),
``timings["keypoints.refine"]``, the mean over the window's pairs that
carry the key."""
import statistics


def read(rec):
    vals = [p["timings"]["keypoints.refine"] for p in rec["pairs"]
            if "keypoints.refine" in p["timings"]]
    return statistics.fmean(vals) if vals else None
