"""stage_s.preprocess: the program's ``downsample`` and ``keypoints``
stages together (voxel filter, PCA, K4's NMS, refinement), seconds a
pair, the mean over the window's pairs."""
import statistics


def read(rec):
    vals = [p["timings"]["downsample"] + p["timings"]["keypoints"]
            for p in rec["pairs"]
            if "downsample" in p["timings"] and "keypoints" in p["timings"]]
    return statistics.fmean(vals) if vals else None
