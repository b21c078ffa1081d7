"""A CPU model of K2's decomposition on the card (csrc/auction.cu
``gs_phase_kernel``, the Gauss-Seidel sweeps it shares with K3) held bit
for bit against the plain version, and the K2 call's contract.

The model: every block holds its own replica of the prices, owners and
open flags (in shared memory, or a slice of a global array past the
shared-memory fit: the same arithmetic); for each active tile the tile's
open rows are cut into column parts over the blocks (g parts a row when
the tile has fewer open rows than blocks), each part scanned by the
block's 512 threads (a thread's 8-column units, merged in a shuffled
order), the parts merged in a shuffled order, the tile's bid rule decided
from the merged parts and each block's replica written in a shuffled
order; the rows left open are completed at the final prices.  Blocks
visit their items in a shuffled order, at 132 and 7 blocks.  Then one case
of the model against the JAX kernel in interpret mode, the escalation
table of the call, the replica-form mirror, and spies on the scalars the
call passes to the launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu_torch.matching.auction as tau
import ghicp_tpu_torch.ops.auction_rounds as tar
from ghicp_tpu.ops.auction_rounds import auction_phase_gs_pallas
from ghicp_tpu_torch.ops.auction_rounds import (NEG, TRACE_SWEEPS,
                                                GsScratch,
                                                auction_phase_gs_cuda,
                                                auction_phase_gs_plain,
                                                escalation_schedule,
                                                gs_replica_form,
                                                gs_scratch, gs_smem_bytes,
                                                gs_tile_rows)

torch.set_num_threads(1)

F32 = np.float32
THREADS, GMAX = 512, 16


def _key(v, row):
    """(orderable(v) << 32) | (0xFFFFFFFF - row), the kernels' bid key."""
    u = int(np.float32(v).view(np.uint32))
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (o << 32) | (0xFFFFFFFF - int(row))


def _val(key):
    o = key >> 32
    u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


def _merge(a, b):
    """t2_merge, element-wise over arrays (v1, j1, v2)."""
    bw = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return (np.where(bw, b[0], a[0]), np.where(bw, b[1], a[1]),
            np.where(bw, np.maximum(b[2], a[0]),
                     np.maximum(a[2], b[0])).astype(F32))


def _merged(parts, rng):
    """The merge of top-2s ``parts`` (arrays of one length) in a shuffled
    pairwise order."""
    v1, j1, v2 = (np.asarray(x) for x in parts)
    order = rng.permutation(len(v1))
    v1, j1, v2 = v1[order], j1[order], v2[order]
    while len(v1) > 1:
        h = len(v1) // 2
        odd = (v1[2 * h:], j1[2 * h:], v2[2 * h:])
        m = _merge((v1[:h], j1[:h], v2[:h]), (v1[h:2 * h], j1[h:2 * h],
                                              v2[h:2 * h]))
        v1, j1, v2 = (np.concatenate([x, y]) for x, y in zip(m, odd))
    return (F32(v1[0]), int(j1[0]), F32(v2[0]))


def _part_scan(b, p, row, u0, u1, rng):
    """A block's top-2 of (b - p) over the units [u0, u1): thread t takes
    the units u0 + t, u0 + t + 512, ..., 8 columns each in order (t2_push
    from t2_empty); the threads' top-2s merged in a shuffled order."""
    v = (b[row] - p).astype(F32)
    units = np.arange(u0, u1)
    m = -(-len(units) // THREADS)
    pad = np.full(m * THREADS, -1)
    pad[:len(units)] = units
    per = pad.reshape(m, THREADS).T                  # [thread, its units]
    valid = np.repeat(per >= 0, 8, axis=1)
    cols = np.where(valid, (per[:, :, None] * 8
                            + np.arange(8)).reshape(THREADS, -1), 0x7FFFFFFF)
    vals = np.where(valid, v[np.where(valid, cols, 0)], -np.inf).astype(F32)
    ar = np.arange(THREADS)
    i1 = np.argmax(vals, axis=1)
    rest = vals.copy()
    rest[ar, i1] = -np.inf
    v2 = np.maximum(rest.max(axis=1), F32(NEG)).astype(F32)
    return _merged((vals[ar, i1], cols[ar, i1], v2), rng)


# the replica's arrays each form keeps in global memory, a slice a block
GLOBAL = {0: (), 1: ("own",), 2: ("p", "own", "open")}
SOLO_UNITS = 2048   # the endgame: block 0 alone from this scan a tile


def _model(b, p0, owner0, sunk0, open0, eps, sink, max_rounds, ts, sched,
           nblocks, rng, form=0):
    """K2 as the card decomposes it, in replica form ``form``: (p, owner,
    sunk, rounds, gcol, trace, the most column parts a row, the sweep the
    solo endgame began at or None).  From the sweep whose open rows would
    cost at most SOLO_UNITS 8-column units of scan an active tile, block 0
    goes on alone: it scans whole rows and the other blocks' replicas
    stop."""
    S, C = b.shape
    U = C // 8
    n_tiles = S // ts
    eps, sink = F32(eps), F32(sink)
    gcap = min(GMAX, max(1, U // 64))
    start = dict(p=p0.astype(F32), own=owner0.astype(np.int64),
                 open=open0 != 0)
    # global arrays [blocks, n], each block's replica a view of its row
    glob = {k: np.stack([start[k]] * nblocks) for k in GLOBAL[form]}
    reps = [{k: glob[k][blk] if k in glob else start[k].copy()
             for k in start} for blk in range(nblocks)]
    sunk = sunk0.astype(np.int32).copy()
    r, scans, active, max_g, solo_at = 0, 0, [], 1, None
    n_open0 = int(reps[0]["open"].sum())
    while True:
        R0 = reps[0]
        per = R0["open"].reshape(n_tiles, ts).sum(axis=1)
        if per.sum() == 0 or r >= max_rounds:
            break
        tiles = np.nonzero(per > 0)[0]
        if solo_at is None and per.sum() * U <= SOLO_UNITS * len(tiles):
            solo_at, nblocks, reps = r, 1, reps[:1]
        active.append(len(tiles))
        eps_r = F32(eps * F32(sched[r]))
        for tile in tiles:
            rows = [tile * ts + i for i in range(ts)
                    if reps[0]["open"][tile * ts + i]]
            n = len(rows)
            scans += n
            g = 1 if solo_at is not None else min(gcap,
                                                   max(1, nblocks // n))
            max_g = max(max_g, g)
            items = [(i, q) for i in range(n) for q in range(g)]
            parts = {}
            # each block scans its items (it, it + nblocks, ...) at its own
            # replica's prices, in a shuffled block order
            for blk in rng.permutation(nblocks):
                for it in range(blk, n * g, nblocks):
                    i, q = items[it]
                    parts[(i, q)] = _part_scan(b, reps[blk]["p"], rows[i],
                                               q * U // g, (q + 1) * U // g,
                                               rng)
            # every block resolves identically on its own replica
            for blk in rng.permutation(nblocks):
                R = reps[blk]
                dec = []
                for i in range(n):
                    o = _merged(tuple(zip(*(parts[(i, q)]
                                            for q in range(g)))), rng)
                    if o[0] <= sink:
                        dec.append((-1, 0))
                    else:
                        delta = F32(F32(o[0] - max(o[2], sink)) + eps_r)
                        dec.append((o[1], _key(delta, rows[i])))
                best = {}
                for col, key in dec:
                    if col >= 0:
                        best[col] = max(best.get(col, 0), key)
                writes = []
                for i in rng.permutation(n):
                    col, key = dec[i]
                    row = rows[i]
                    if col < 0:
                        writes.append(("close", row))
                        if i % nblocks == blk:
                            sunk[row] = 1
                        continue
                    if key == best[col]:   # no higher key on the column
                        victim = int(R["own"][col])
                        R["own"][col] = row
                        R["p"][col] = F32(R["p"][col] + _val(key))
                        writes.append(("close", row))
                        if victim >= 0:
                            writes.append(("reopen", victim))
                for kind, row in writes:
                    R["open"][row] = kind == "reopen"
        r += 1
    for R in reps[1:]:
        for k in ("p", "own", "open"):
            assert np.array_equal(R[k], reps[0][k]), k
    R = reps[0]
    gcol = np.full(S, -1, np.int32)
    for row in np.nonzero(R["open"])[0]:
        o = _part_scan(b, R["p"], row, 0, U, rng)
        gcol[row] = o[1] if o[0] > sink else C
    trace = [n_open0, r, scans] + active[:TRACE_SWEEPS]
    return (R["p"], R["own"].astype(np.int32), sunk, r, gcol, trace, max_g,
            solo_at)


def _problem(seed, S, C, frac=0.3):
    rng = np.random.default_rng(seed)
    b = rng.uniform(-4, 0, (S, C)).astype(F32)
    b[rng.random((S, C)) < frac] = F32(NEG)
    return np.array(torch.from_numpy(b).to(torch.bfloat16).float())


def _cold(S, C):
    return (np.zeros(C, F32), np.full(C, -1, np.int32), np.zeros(S, np.int32),
            np.ones(S, np.int32))


def _warm(b, eps, sink, ts, rng):
    """A converged cold phase with 10 % of its columns released."""
    S, C = b.shape
    p, o, s, _, _ = auction_phase_gs_plain(
        torch.from_numpy(b), *map(torch.from_numpy, _cold(S, C)), eps, sink,
        400, ts)
    p, o, s = p.numpy(), o.numpy(), s.numpy()
    rel = (rng.random(C) < 0.1) & (o >= 0)
    o = np.where(rel, -1, o).astype(np.int32)
    p = np.where(rel, 0.0, np.maximum(p - 2 * eps, 0.0)).astype(F32)
    owned = np.zeros(S, bool)
    owned[o[o >= 0]] = True
    return p, o, s, (~owned & (s == 0)).astype(np.int32)


def _plain(b, state, eps, sink, budget, ts, sched):
    trace = torch.zeros(3 + TRACE_SWEEPS, dtype=torch.int32)
    out = auction_phase_gs_plain(torch.from_numpy(b),
                                 *map(torch.from_numpy, state), eps, sink,
                                 budget, ts, torch.from_numpy(sched), True,
                                 trace=trace)
    p, o, s, r, g = out
    return (p.numpy(), o.numpy(), s.numpy(), int(r), g.numpy(),
            trace[:3 + int(r)].tolist())


@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("nblocks", [132, 7])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_k2_block_model_matches_plain(nblocks, start, form):
    """512 x 2048 (a tile of 256 rows, up to 4 column parts a row), budget
    40 with escalation after 6 sweeps, each replica form: outputs, sweeps
    and trace bit-equal; warm starts leave few open rows a tile, so their
    tiles are split into parts."""
    S, C = 512, 2048
    b = _problem(3, S, C)
    ts = gs_tile_rows(C)
    eps, sink, budget = 0.05, -2.0, 40
    sched = escalation_schedule(budget, 6, 2).numpy()
    rng = np.random.default_rng(nblocks)
    state = _cold(S, C) if start == "cold" else _warm(b, eps, sink, ts, rng)
    want = _plain(b, state, eps, sink, budget, ts, sched)
    got = _model(b, *state, eps, sink, budget, ts, sched, nblocks, rng,
                 form)
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    for k in (1, 2, 4):
        assert np.array_equal(got[k], want[k]), k
    assert got[3] == want[3]
    assert got[5] == want[5]
    if start == "warm" and nblocks == 132:
        assert got[6] > 1   # tiles with few open rows were cut into parts


@pytest.mark.parametrize("form", [0, 2])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_k2_block_model_endgame(start, form):
    """512 x 1024 in tiles of 32 rows at eps 0.002 (a longer tail): the
    sweeps run on the grid while the open rows are dense, then block 0
    alone (the solo endgame, whole-row scans; a warm start's few open rows
    from its first sweep); outputs, sweeps and trace bit-equal to the
    plain version."""
    S, C, ts = 512, 1024, 32
    b = _problem(3, S, C)
    eps, sink, budget = 0.002, -2.0, 400
    sched = escalation_schedule(budget, budget // 4, budget // 16).numpy()
    rng = np.random.default_rng(7)
    state = _cold(S, C) if start == "cold" else _warm(b, eps, sink, ts, rng)
    want = _plain(b, state, eps, sink, budget, ts, sched)
    got = _model(b, *state, eps, sink, budget, ts, sched, 132, rng, form)
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    for k in (1, 2, 4):
        assert np.array_equal(got[k], want[k]), k
    assert got[3] == want[3] and got[5] == want[5]
    # the cold start's dense first sweep runs on the grid
    assert got[7] is not None and got[7] < got[3]
    assert start == "warm" or got[7] >= 1


def test_k2_block_model_budget_cut_completes_open_rows():
    """A budget of one sweep leaves the rows evicted in it open: their
    greedy completion at the final prices (the block-wide scan a row)
    equals the plain version's, at 7 blocks."""
    S, C = 512, 1024
    b = _problem(9, S, C, frac=0.1)
    ts = 128
    sched = escalation_schedule(1, 0, 1).numpy()
    rng = np.random.default_rng(2)
    want = _plain(b, _cold(S, C), 0.01, -3.0, 1, ts, sched)
    got = _model(b, *_cold(S, C), 0.01, -3.0, 1, ts, sched, 7, rng)
    assert (want[4] >= 0).any()
    for k in (1, 2, 4):
        assert np.array_equal(got[k], want[k]), k
    assert got[5] == want[5]


def test_k2_block_model_matches_jax_gs_kernel():
    """The model against the JAX package's K2 in interpret mode, the
    fixture of tests/test_torch_auction_rounds.py (no escalation: the
    packages' exp2 may differ by an ulp)."""
    S, C = 512, 640
    b = _problem(7, S, C)
    eps, sink, budget = 0.05, -2.0, 40
    state = _cold(S, C)
    J = auction_phase_gs_pallas(
        jnp.asarray(b).astype(jnp.bfloat16), *map(jnp.asarray, state), eps,
        sink, budget, ts=128, inner_cap=1, esc_after=0, esc_period=1,
        complete_open=1, interpret=True)
    got = _model(b, *state, eps, sink, budget, 128,
                 escalation_schedule(budget, 0, 1).numpy(), 132,
                 np.random.default_rng(0))
    for j, m in zip(J, got[:5]):
        assert np.array_equal(np.asarray(j), np.asarray(m))


@pytest.mark.parametrize("S,C,form", [(8192, 8192, 0), (16384, 16384, 0),
                                      (24576, 24576, 1), (32768, 32768, 1),
                                      (8192, 57344, 2)])
def test_replica_form_mirror(S, C, form):
    """The replica in shared memory serves K2 to ~23,500 slots, with its
    owners in global memory to ~42,000 (the JAX warm gate's 32,768
    included), all of it in global memory past that (its shared memory
    is the tile scratch alone); a scratch may force a larger form, not a
    smaller one."""
    ts = gs_tile_rows(C)
    assert gs_replica_form(S, C, ts) == form
    for f in (0, 1, 2):
        assert (gs_smem_bytes(S, C, ts, f) <= 232448) == (f >= form or f == 2)
    assert gs_smem_bytes(S, C, ts, 2) < 48 * 1024
    assert gs_replica_form(S, C, 1024) == -1
    if form < 2:
        assert GsScratch("cpu", 512, 1024, 256, form=2).form == 2
    with pytest.raises(ValueError):
        GsScratch("cpu", S, C, ts, form=form - 1 if form else -1)


def test_call_escalation_table_is_made_once():
    """The K2 call's escalation table equals escalation_schedule and is
    the same tensor on every call with the same key."""
    sc = GsScratch("cpu", 512, 1024, 256)
    for key in ((40, 10, 2), (8, 2, 1), (1, 0, 1), (32, 8, 2)):
        t = sc.schedule(*key)
        assert torch.equal(t, escalation_schedule(*key))
        assert sc.schedule(*key) is t
    assert gs_scratch("cpu", 512, 1024, 256) is gs_scratch("cpu", 512, 1024,
                                                           256)


class _NoHostReads:
    """Inside: reading a tensor's value on the host, or making a tensor
    from host data, raises."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def __enter__(self):
        def refuse(*a, **k):
            raise AssertionError("a host read or a host tensor")
        for name in ("__float__", "__int__", "__bool__", "__index__", "item",
                     "tolist", "numpy", "cpu"):
            self.mp.setattr(torch.Tensor, name, refuse)
        as_tensor = torch.as_tensor

        def only_tensors(x, *a, **k):
            if not torch.is_tensor(x):
                refuse()
            return as_tensor(x, *a, **k)
        self.mp.setattr(torch, "tensor", refuse)
        self.mp.setattr(torch, "as_tensor", only_tensors)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _one_phase_inputs(S=256, C=512):
    b = torch.from_numpy(_problem(5, S, C)).to(torch.bfloat16)
    acol = torch.full((S,), -1, dtype=torch.int64)
    acol[::5] = tau.SINK
    owner = torch.full((C,), -1, dtype=torch.int64)
    p = torch.zeros(C)
    return b, acol, owner, p


def test_gs_phases_one_phase_reads_nothing_back(monkeypatch):
    """At n_phases == 1, _gs_phases hands K2 epsilon and the sink as the
    device scalars it was given and reads no value back: no host read and
    no tensor made from host data before or after the launch."""
    b, acol, owner, p = _one_phase_inputs()
    seen = []
    real = tau.auction_phase_gs
    outs = real(b, p, owner.to(torch.int32), (acol == tau.SINK).int(),
                (acol == -1).int(), 0.05, -2.0, 40, ts=256, esc_after=10,
                esc_period=2, complete_open=True)
    outs = outs[:3] + (torch.as_tensor(outs[3]),) + outs[4:]

    def spy(*a, **k):
        seen.append((a, k))
        return outs
    monkeypatch.setattr(tau, "auction_phase_gs", spy)
    eps_final = torch.tensor(0.05)
    sink = torch.tensor(-2.0)
    with _NoHostReads(monkeypatch):
        acol_n, p_n, spent, eps_bound = tau._gs_phases(
            b, sink, eps_final, eps_final * 4, owner, acol, p, 40, 1)
    (a, k), = seen
    assert a[5] is eps_final and a[6] is sink
    assert k["complete_open"] and (k["esc_after"], k["esc_period"]) == (10, 2)
    assert torch.is_tensor(spent) and torch.is_tensor(eps_bound)
    want = 0.05 * 2.0 ** (max(int(outs[3]) - 10, 0) / 2)
    assert float(eps_bound) == pytest.approx(want, rel=1e-6)


def test_k2_call_passes_device_scalars(monkeypatch):
    """The K2 call launches with the addresses of the epsilon and sink
    scalars it was given, the cached escalation table and the shape's
    scratch: no clone of the start state, no host read."""
    b, acol, owner, p = _one_phase_inputs()
    S, C = b.shape
    calls = []

    class Lib:
        def gs_phase(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(tar, "_lib", lambda: Lib())

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    sc = GsScratch("cpu", S, C, 256)
    sched = sc.schedule(40, 10, 2)
    eps, sink = torch.tensor(0.05), torch.tensor(-2.0)
    state = (p, owner.to(torch.int32), (acol == tau.SINK).int(),
             (acol == -1).int())
    with _NoHostReads(monkeypatch):
        auction_phase_gs_cuda(b, *state, eps, sink, 40, 256, sched, True,
                              scratch=sc)
    (args,) = calls
    assert args[0] == b.data_ptr()
    assert args[2:6] == tuple(x.data_ptr() for x in state)
    assert args[6] == sched.data_ptr()
    assert args[7] == eps.data_ptr() and args[8] == sink.data_ptr()
    assert args[9:14] == (40, 1, S, C, 256)
    assert args[19:24] == sc.ptrs
    assert args[24:26] == (sc.nblk, sc.form)
