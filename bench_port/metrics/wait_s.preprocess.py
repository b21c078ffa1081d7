"""wait_s.preprocess: seconds a pair the host waited on the card in the
program's ``downsample`` and ``keypoints`` stages, the sum of their
``timings`` keys ``<stage>.wait`` and ``<stage>.<...>.wait`` (the voxel
counts, the PCA's cell counts, the NMS rounds, the keypoint masks and the
stages' closing synchronisations), the mean over the window's pairs that
carry them."""
import statistics


def waits(timings):
    return [v for k, v in timings.items()
            if k.startswith(("downsample.", "keypoints."))
            and k.endswith(".wait")]


def read(rec):
    vals = [sum(w) for w in (waits(p["timings"]) for p in rec["pairs"]) if w]
    return statistics.fmean(vals) if vals else None
