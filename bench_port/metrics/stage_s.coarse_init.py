"""stage_s.coarse_init: the program's ``coarse_init`` stage, seconds a pair
(``RegistrationOutput.timings``, each stage synchronised at its end),
the mean over the window's pairs."""
import statistics


def read(rec):
    vals = [p["timings"]["coarse_init"] for p in rec["pairs"]
            if "coarse_init" in p["timings"]]
    return statistics.fmean(vals) if vals else None
