"""Reading the profiler's trace of the traced slice, kept in memory.

From ``torch.profiler`` over a few pairs: the device's operations
(kernels, copies and fills on the card, by name, start and duration), the
host's ranges (the program's ``pipeline.<stage>`` ranges and the
benchmark's own ``bench.*`` spans), and from them the device's busy time
(the union of its operations' intervals), the idle gaps, and what the
host was doing in each gap (the innermost range open at the gap's
middle).
"""
from __future__ import annotations

# activity types of work on the device; the card's copies of the host's
# ranges ("gpu_user_annotation") span whole stages and are not work
DEVICE_WORK = ("kernel", "memcpy", "memset")
HOST_RANGES = ("pipeline.", "bench.")
TOP = 10
# a kernel's name as the breakdown gives it: PyTorch's templated names
# run to thousands of characters, the head tells them apart
NAME_CHARS = 160


def _is_work(kind: str, name: str, annotations: set) -> bool:
    """Whether a device event is work: a kernel, a copy or a fill, and not
    the card's copy of a host range (which older PyTorch builds do not
    mark by activity type, so it is known by its name)."""
    kind = kind.lower()
    if "annotation" in kind or name in annotations:
        return False
    return not kind or any(k in kind for k in DEVICE_WORK)


def events(prof) -> dict:
    """{"device": [(name, start_ns, end_ns)], "host": [(name, start_ns,
    end_ns)]} from a finished ``torch.profiler.profile``'s raw results
    (kept in memory; parsing them into PyTorch's event tree takes far
    longer)."""
    rows = []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        kind = (str(e.activity_type()) if hasattr(e, "activity_type")
                else "")
        rows.append((e.name(), t0, t0 + e.duration_ns(), kind,
                     "CUDA" in str(e.device_type()),
                     bool(e.is_user_annotation())))
    host = [(n, a, b) for n, a, b, _, on_dev, ann in rows
            if not on_dev and ann and n.startswith(HOST_RANGES)]
    annotations = {n for n, _, _, _, on_dev, ann in rows
                   if ann and not on_dev}
    dev = [(n, a, b) for n, a, b, kind, on_dev, _ in rows
           if on_dev and _is_work(kind, n, annotations)]
    return {"device": dev, "host": host}


def union(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, t0: int, t1: int) -> list:
    """The idle (start, end) intervals of [t0, t1] outside ``busy``."""
    out, at = [], t0
    for a, b in busy:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def host_label(host: list, t: float) -> str:
    """The innermost host range open at ``t``: the latest to start, of
    those the shortest."""
    best = None
    for name, a, b in host:
        if a <= t <= b and (best is None or (a, -b) > best[1]):
            best = (name, (a, -b))
    return best[0] if best else "none"


def summarize(ev: dict, t0: int, t1: int) -> dict:
    """Busy and window seconds of [t0, t1], device seconds by operation
    name, and idle seconds by the host range open in each gap."""
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in ev["device"]
              if b > t0 and a < t1]
    busy = union((a, b) for _, a, b in inside)
    busy_ns = sum(b - a for a, b in busy)
    by_op: dict = {}
    for n, a, b in inside:
        by_op[n] = by_op.get(n, 0) + (b - a)
    idle: dict = {}
    for a, b in gaps(busy, t0, t1):
        label = host_label(ev["host"], (a + b) / 2)
        idle[label] = idle.get(label, 0) + (b - a)

    def top(d):
        return [[k[:NAME_CHARS], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ns_by_op": by_op,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}
