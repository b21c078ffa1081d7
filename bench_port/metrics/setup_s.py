"""setup_s: process start to the first timed pair (imports, the build,
the pool's pairs made, every pair registered once)."""


def read(rec):
    return rec["setup_s"]
