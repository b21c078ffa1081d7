"""engine_iters: the engine's iterations a pair (``result.iterations``),
the mean over the window's pairs."""
import statistics


def read(rec):
    vals = [p["iterations"] for p in rec["pairs"]]
    return statistics.fmean(vals) if vals else None
