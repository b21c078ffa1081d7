"""device_idle_share: the share of the traced window in which no kernel,
copy or fill ran on the card (1 - the union of their intervals over the
window), in percent."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
