"""span_s.keypoints.detect: seconds a pair in both clouds' keypoint
detection (stability pruning, the NMS and its rounds' reads),
``timings["keypoints.detect"]``, the mean over the window's pairs that
carry the key."""
import statistics


def read(rec):
    vals = [p["timings"]["keypoints.detect"] for p in rec["pairs"]
            if "keypoints.detect" in p["timings"]]
    return statistics.fmean(vals) if vals else None
