"""wait_s.register: seconds a pair the host waited on the card in the
program's ``register`` stage, the sum of its ``timings`` keys
``register.wait`` and ``register.<...>.wait`` (the engine's reads of
device values and the stage's closing synchronisation), the mean over
the window's pairs that carry them."""
import statistics


def waits(timings):
    return [v for k, v in timings.items()
            if k.startswith("register.") and k.endswith(".wait")]


def read(rec):
    vals = [sum(w) for w in (waits(p["timings"]) for p in rec["pairs"]) if w]
    return statistics.fmean(vals) if vals else None
