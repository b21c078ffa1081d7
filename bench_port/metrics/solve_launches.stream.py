"""solve_launches.stream: K5-family launches a pair (the streaming
sweeps, every variant, each launch once: ``stream_sweep_wide`` counts
again what ``stream_sweep`` counts), from the program's launch counts
over the window."""


def read(rec):
    n = sum(v for p in rec["pairs"] for k, v in p["launches"].items()
            if "@" not in k and k.startswith("stream_sweep")
            and not k.startswith("stream_sweep_wide"))
    return n / len(rec["pairs"]) if n and rec["pairs"] else None
