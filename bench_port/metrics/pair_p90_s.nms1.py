"""pair_p90_s.nms1: the 90th percentile (nearest rank) of every pair's
wall time in the window.  A per-layer metric: the card sits idle most of
such a pair, so the host alone paces this tail."""
import math


def read(rec):
    walls = sorted(p["wall_s"] for p in rec["pairs"])
    if not walls:
        return None
    return walls[math.ceil(0.9 * len(walls)) - 1]
