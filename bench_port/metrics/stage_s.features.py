"""stage_s.features: the program's ``features`` stage, seconds a pair
(``RegistrationOutput.timings``, each stage synchronised at its end),
the mean over the window's pairs."""
import statistics


def read(rec):
    vals = [p["timings"]["features"] for p in rec["pairs"]
            if "features" in p["timings"]]
    return statistics.fmean(vals) if vals else None
