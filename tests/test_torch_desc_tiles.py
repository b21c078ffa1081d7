"""A step-by-step model of K5-mult's blocking on the CPU (csrc/stream.cu
``desc_kernel<DT, STATS, COL>``): blocks of DESC_RT source rows, each
tile's valid columns compacted to the front in order, a thread's 4 rows
against its 4 columns of every pass of 32, each similarity summed over the
dimensions in increasing order from +0, the statistics in float over a
thread's columns of a tile and folded into double once a tile, the
partial top-2s merged over column groups and column splits, vsel from the
row's own formula, and with the column side one key a column and block
from a half-warp's 64 rows, folded after a vote against the staged key;
blocks, splits and column groups run in shuffled orders.  It must give
``stream_sweep_plain`` bit for bit: FPFH's D = 33 (128-column tiles) and
RoPS's D = 135 (64-column tiles), planted tied columns, with and without
the statistics, with the column side."""
import numpy as np
import pytest
import torch

from ghicp_tpu_torch.ops.cost_kernel import (_f32, _factors, factor_ed,
                                             mult_cost)
from ghicp_tpu_torch.ops.stream_kernel import (DESC_PASS, DESC_RT, DESC_TM,
                                               DESC_TN, NEG, NO_COL, NO_ROW,
                                               STAT_FIELDS, _COL_KEY0,
                                               _merge_top2, _top2_init,
                                               desc_tile_cols, lex_merge_top2,
                                               make_desc_features,
                                               stream_sweep,
                                               stream_sweep_plain)

torch.set_num_threads(1)
_M32 = np.uint64(0xFFFFFFFF)
_NO_KEY = np.uint64(0xFFFFFFFF)


def _args(rng, S, C, D, ties: bool):
    """Sweep inputs on the similarity lane; with ``ties`` every 7th target
    column copies its left neighbour (coordinates, descriptor, price) and
    row 2k + 1 copies row 2k (coordinates, descriptor, mask), so columns
    and rows tie."""
    t = torch.from_numpy
    kp_t = rng.uniform(-6, 6, (C, 3)).astype(np.float32)
    desc_t = rng.gamma(2.0, 5.0, (C, D)).astype(np.float32)
    prices = rng.uniform(0, 0.3, C).astype(np.float32)
    mt = rng.random(C) < 0.85
    partner = rng.integers(0, C, S)
    kp_s = kp_t[partner] + rng.normal(0, 0.3, (S, 3)).astype(np.float32)
    desc_s = desc_t[partner] + rng.normal(0, 3.0, (S, D)).astype(np.float32)
    ms = rng.random(S) < 0.9
    if ties:
        dup = np.arange(7, C, 7)
        for x in (kp_t, desc_t, prices, mt):
            x[dup] = x[dup - 1]
        for x in (kp_s, desc_s, ms):
            x[1::2] = x[0::2][:S // 2]
    acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S), -1)
    acol[::11] = 2**30
    feats = make_desc_features(t(desc_s), t(desc_t),
                               "rows" if D == 33 else "dims")
    return (t(kp_s), t(kp_t), feats, t(ms), t(mt), t(prices), t(acol), 1.0,
            1.0 / 3.0, 0.08)


def _desc_model(args, splits: int, rng, stats: bool, col: bool):
    """desc_kernel step by step; returns (v1, j1, v2, j2, vsel, stats or
    None, cmin, crow)."""
    kp_s, kp_t, feats, ms, mt, prices, acol, _, wfd, scale = args
    S, C, D = kp_s.shape[0], kp_t.shape[0], feats.dim
    COLS = desc_tile_cols(D)
    ks, kt = _factors(kp_s), _factors(kp_t)
    fs = feats.fs[:, :D].to(torch.float32)
    ft = feats.ft[:, :D].to(torch.float32)
    k = torch.tensor(_f32(wfd), dtype=torch.float32)
    mt_np, p = mt.numpy(), prices
    n_rb, n_ct = -(-S // DESC_RT), -(-C // COLS)
    tps = -(-n_ct // splits)
    colkey = np.full(C, _COL_KEY0, np.uint64)
    parts = {}
    cnt, dsum, dsq = 0, 0.0, 0.0
    mcd, med, mincd = np.float32(0), np.float32(0), np.float32(3.4e38)
    for b, y in rng.permutation([(b, y) for b in range(n_rb)
                                 for y in range(splits)]):
        rows = b * DESC_RT + np.arange(DESC_RT)
        rows_in = np.minimum(rows, S - 1)
        live = (rows < S) & ms.numpy()[rows_in]
        lv = torch.from_numpy(live)
        a = fs[rows_in]
        # one top-2 per column group (8 of them: TN columns of each pass)
        groups = [_top2_init(DESC_RT, "cpu") for _ in range(DESC_PASS
                                                            // DESC_TN)]
        nvalid = 0
        older = colkey.copy()
        for tile in range(y * tps, min(n_ct, (y + 1) * tps)):
            cols = tile * COLS + np.arange(COLS)
            cols = cols[cols < C]
            comp = cols[mt_np[cols]]          # compacted, increasing
            n = comp.size
            nvalid += n
            if not n:
                continue
            c = torch.from_numpy(comp)
            acc = torch.zeros((DESC_RT, n), dtype=torch.float32)
            for d in range(D):                # increasing order from +0
                acc = acc + a[:, d:d + 1] * ft[c, d][None, :]
            ed = torch.where(lv[:, None], factor_ed(ks[rows_in], kt[c],
                                                    scale),
                             torch.tensor(float("nan")))
            cd = mult_cost(ed, acc.abs(), k)
            v = torch.where(lv[:, None], -cd - p[c][None, :], NEG)
            # column group g owns compacted positions 32 pass + 4 g + j
            grp = (np.arange(n) % DESC_PASS) // DESC_TN
            for g in rng.permutation(len(groups)):
                qs = np.flatnonzero(grp == g)
                if not qs.size:
                    continue
                groups[g] = _merge_top2(groups[g], v[:, qs],
                                        torch.from_numpy(comp[qs]))
                if stats:
                    # a thread's rows: float sums over its columns of the
                    # tile, in order, folded into double
                    fsum = torch.zeros(DESC_RT, dtype=torch.float32)
                    fsq = torch.zeros(DESC_RT, dtype=torch.float32)
                    for q in qs:
                        fsum = fsum + cd[:, q]
                        fsq = fsq + cd[:, q] * cd[:, q]
                    dsum += float(fsum[lv].to(torch.float64).sum())
                    dsq += float(fsq[lv].to(torch.float64).sum())
            if stats and live.any():
                cdl, edl = cd[lv].numpy(), ed[lv].numpy()
                mcd = max(mcd, cdl.max())
                med = max(med, edl.max())
                mincd = min(mincd, cdl.min())
            if col:
                staged = (older if rng.random() < 0.5 else colkey)[comp] >> \
                    np.uint64(32)
                cdn = cd.numpy()
                for q in rng.permutation(n):
                    m = np.fmin.reduce(cdn[:, q])     # NaN rows skipped
                    if m != m:
                        continue
                    bits = np.uint64(np.float32(m + np.float32(0.0)).view(
                        np.uint32))
                    if bits > staged[q]:              # the vote
                        continue
                    row = rows[np.flatnonzero(cdn[:, q] == m)[0]]
                    key = (bits << np.uint64(32)) | np.uint64(row)
                    colkey[comp[q]] = min(colkey[comp[q]], key)
        state = _top2_init(DESC_RT, "cpu")
        for g in rng.permutation(len(groups)):
            state = lex_merge_top2(state, groups[g])
        cnt += int(live.sum()) * nvalid
        parts[(b, y)] = (state, rows, live)
    v1, j1, v2, j2 = _top2_init(S, "cpu")
    for y in rng.permutation(splits):
        sv1, sj1, sv2, sj2 = _top2_init(S, "cpu")
        for b in range(n_rb):
            (a1, b1, a2, b2), rows, live = parts[(b, y)]
            keep = torch.from_numpy(live)
            idx = torch.from_numpy(rows[live])
            sv1[idx], sj1[idx], sv2[idx], sj2[idx] = (a1[keep], b1[keep],
                                                      a2[keep], b2[keep])
        v1, j1, v2, j2 = lex_merge_top2((v1, j1, v2, j2),
                                        (sv1, sj1, sv2, sj2))
    # vsel: the row's own pair, its dot summed in increasing order
    vsel = torch.full((S,), NEG, dtype=torch.float32)
    for row in range(S):
        ac = int(acol[row])
        if not (bool(ms[row]) and 0 <= ac < C and bool(mt[ac])):
            continue
        dot = torch.zeros((), dtype=torch.float32)
        for d in range(D):
            dot = dot + fs[row, d] * ft[ac, d]
        ed = factor_ed(ks[row:row + 1], kt[ac:ac + 1], scale)[0, 0]
        vsel[row] = -mult_cost(ed, dot.abs(), k) - p[ac]
    st = (cnt, dsum, dsq, mcd, med, -mincd) if stats else None
    cmin = (colkey >> np.uint64(32)).astype(np.uint32).view(np.float32)
    crow = (colkey & _M32).astype(np.int64)
    return v1, j1, v2, j2, vsel, st, cmin, crow


@pytest.mark.parametrize("D,S,C,splits,ties,stats,col", [
    (33, 150, 300, 1, False, True, False),
    (33, 200, 420, 2, True, True, False),
    (33, 200, 420, 3, True, False, False),
    (33, 130, 300, 2, True, True, True),
    (135, 140, 200, 2, True, True, False),
    (135, 100, 170, 3, False, False, False),
    (135, 128, 200, 1, True, True, True)])
def test_desc_blocking_model_matches_plain(D, S, C, splits, ties, stats,
                                           col):
    rng = np.random.default_rng(D + S + C + splits)
    a = _args(rng, S, C, D, ties)
    want = stream_sweep_plain(*a, tc=96, col_side=col, with_stats=stats)
    v1, j1, v2, j2, vsel, st, cmin, crow = _desc_model(a, splits, rng,
                                                       stats, col)
    for got, w in ((v1, want.v1), (j1, want.j1), (v2, want.v2),
                   (j2, want.j2), (vsel, want.vsel)):
        assert torch.equal(got, w)
    assert (vsel > NEG).sum() > S // 3
    if ties:
        # the planted tied columns: never won by the higher of a pair
        assert not np.isin(j1.numpy(), np.arange(7, C, 7)).any()
        assert np.isin(j1.numpy(), np.arange(6, C, 7)).any()
    if stats:
        cnt, dsum, dsq, mcd, med, bmax = st
        assert cnt == int(want.cnt)
        for g, w in ((dsum, want.cd_sum), (dsq, want.cd_sumsq)):
            assert abs(g - float(w)) <= 1e-4 * abs(float(w))
        for g, w in ((mcd, want.cd_max), (med, want.ed_max),
                     (bmax, want.b_max)):
            assert np.float32(g) == np.float32(float(w))
        assert float(want.fd_max) == 0.0
    else:
        assert all(torch.isnan(getattr(want, f)) for f in STAT_FIELDS)
    if col:
        np.testing.assert_array_equal(cmin.view(np.uint32),
                                      want.cmin.numpy().view(np.uint32))
        np.testing.assert_array_equal(crow, want.crow.numpy())
        valid = crow < NO_ROW
        assert valid.sum() > C // 2
        assert (cmin[~valid] == np.float32(NO_COL)).all()
        if ties:
            assert (crow[valid] % 2 == 0).all()


def test_desc_tile_shapes():
    """The kernel's tile shapes: 128 columns at D = 33, 64 otherwise; a
    pass of 32 columns is 8 column groups of 4; a block is 16 row groups
    of 4."""
    assert desc_tile_cols(33) == 128
    assert desc_tile_cols(135) == desc_tile_cols(32) == 64
    assert DESC_PASS == 8 * DESC_TN and DESC_RT == 16 * DESC_TM
    for D in (33, 135):
        assert desc_tile_cols(D) % DESC_PASS == 0


def test_similarity_sweep_on_the_cpu_is_the_plain_version():
    """``stream_sweep`` on CPU tensors is the plain version on the
    similarity lane, with the column side and without the statistics."""
    rng = np.random.default_rng(4)
    a = _args(rng, 96, 160, 33, True)
    for kw in (dict(col_side=True), dict(with_stats=False)):
        got, want = stream_sweep(*a, **kw), stream_sweep_plain(*a, **kw)
        for f in ("v1", "j1", "v2", "j2", "vsel"):
            assert torch.equal(getattr(got, f), getattr(want, f))
