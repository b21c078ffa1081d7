"""pairs_per_min: pairs completed over the whole window, per minute."""


def read(rec):
    if not rec["pairs"] or rec["window_s"] <= 0:
        return None
    return 60.0 * len(rec["pairs"]) / rec["window_s"]
