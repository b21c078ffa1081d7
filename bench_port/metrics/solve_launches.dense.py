"""solve_launches.dense: K2 and K3 launches a pair (the dense auction's
Gauss-Seidel phases and warm fused solves, every variant), from the
program's launch counts over the window."""
KERNELS = ("auction_phase_gs", "auction_warm_fused")


def read(rec):
    n = sum(v for p in rec["pairs"] for k, v in p["launches"].items()
            if "@" not in k and k.startswith(KERNELS))
    return n / len(rec["pairs"]) if n and rec["pairs"] else None
