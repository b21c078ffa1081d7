"""host_s.solve: seconds a pair of the engine's matching solves that the
host did not spend waiting on the card: ``timings["register.solve"]``
less its ``register.solve.wait`` and ``register.solve.<...>.wait`` keys
(the host's loop, launches and Python work of every solve, the kernels'
time only where the host waited on them outside a read), the mean over
the window's pairs that carry the key."""
import statistics


def host(timings):
    return timings["register.solve"] - sum(
        v for k, v in timings.items()
        if k.startswith("register.solve.") and k.endswith(".wait"))


def read(rec):
    vals = [host(p["timings"]) for p in rec["pairs"]
            if "register.solve" in p["timings"]]
    return statistics.fmean(vals) if vals else None
