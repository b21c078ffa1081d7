"""stage_s.register: the program's ``register`` stage, seconds a pair
(``RegistrationOutput.timings``, each stage synchronised at its end),
the mean over the window's pairs."""
import statistics


def read(rec):
    vals = [p["timings"]["register"] for p in rec["pairs"]
            if "register" in p["timings"]]
    return statistics.fmean(vals) if vals else None
