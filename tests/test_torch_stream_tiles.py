"""What the tiled K5 design adds, on the CPU: the unpacked int8 bit rows of
the BSC factors (against the JAX package's ``StreamFeatures`` bits), the
Hamming term as an integer product over them, ``subset_rows`` on both
forms, the statistics-free sweep, the order-free top-2 merge the kernels
fold their partial results with, and the integer and float identities the
CUDA kernels rest on (the biased FD, the nibble spread of a packed word,
the masked price)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ghicp_tpu.features.bsc import pack_bits as jax_pack_bits
from ghicp_tpu.ops.stream_kernel import make_stream_features as jax_feats
from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.matching.stream_auction import sweep_moments
from ghicp_tpu_torch.ops.stream_kernel import (
    BIT_ROW, DESC_RT, HAM_TC, NONE_RT, NONE_TC, NEG, RT, STAT_FIELDS,
    NoFeatures, _merge_top2, _top2_init, check_target, column_splits,
    desc_tile_cols, lex_merge_top2, make_desc_features, make_stream_features,
    popcount32, stream_selected, stream_sweep, stream_sweep_plain,
    subset_rows, sweep_target, unpack_bits8)

torch.set_num_threads(1)
N_BITS = 441


def _bits(rng, V, S, C):
    bs = (rng.random((V, S, N_BITS)) < 0.3).astype(np.float32)
    bt = (rng.random((1, C, N_BITS)) < 0.3).astype(np.float32)
    return bs, bt


def _feats(bs, bt):
    return make_stream_features(pack_bits(torch.from_numpy(bs)),
                                pack_bits(torch.from_numpy(bt)))


@pytest.mark.parametrize("V", [1, 2, 4])
def test_unpacked_bits_equal_jax_bits(V):
    rng = np.random.default_rng(V)
    bs, bt = _bits(rng, V, 96, 80)
    f = _feats(bs, bt)
    jf = jax_feats(packed_s=jax_pack_bits(jnp.asarray(bs)),
                   packed_t=jax_pack_bits(jnp.asarray(bt)), n_bits=N_BITS)
    fs, ft = np.asarray(jf.fs), np.asarray(jf.ft)
    assert f.bits_s.dtype == torch.int8 and f.bits_t.dtype == torch.int8
    assert tuple(f.bits_s.shape) == (V, 96, BIT_ROW)
    assert tuple(f.bits_t.shape) == (80, BIT_ROW)
    assert f.bits_s.is_contiguous() and f.bits_t.is_contiguous()
    np.testing.assert_array_equal(f.bits_s.numpy(), fs[..., :BIT_ROW])
    np.testing.assert_array_equal(f.bits_t.numpy(), ft[:, :BIT_ROW])
    assert not fs[..., BIT_ROW:].any() and not ft[:, BIT_ROW:].any()
    np.testing.assert_array_equal(f.na.numpy(), np.asarray(jf.na))
    np.testing.assert_array_equal(f.nb.numpy(), np.asarray(jf.nb))


@pytest.mark.parametrize("V", [1, 2, 4])
def test_integer_product_gives_the_xor_popcount_fd(V):
    """min_v (na_v + nb - 2 a_v . b) in int32 over the int8 rows (the
    tensor-core kernel's sum) equals the XOR-popcount FD of every pair and
    the gathered FD of ``stream_selected``."""
    rng = np.random.default_rng(10 + V)
    S, C = 70, 90
    bs, bt = _bits(rng, V, S, C)
    f = _feats(bs, bt)
    dot = torch.einsum("vsk,ck->vsc", f.bits_s.to(torch.int32),
                       f.bits_t.to(torch.int32))
    h = (f.na.to(torch.int32)[:, :, None] + f.nb.to(torch.int32)[None, None]
         - 2 * dot).amin(dim=0)
    x = (f.words_s.to(torch.int64)[:, :, None]
         ^ f.words_t.to(torch.int64)[None, None])
    want = popcount32(x).sum(dim=-1).amin(dim=0)
    assert torch.equal(h.to(torch.int64), want)
    kp_s = torch.from_numpy(rng.uniform(-5, 5, (S, 3)).astype(np.float32))
    kp_t = torch.from_numpy(rng.uniform(-5, 5, (C, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, C, S))
    fd = stream_selected(kp_s, kp_t, f, idx, 0.7, 0.3, 0.1)[2]
    assert torch.equal(fd, h[torch.arange(S), idx].to(torch.float32))


def test_subset_rows_keeps_both_forms_aligned():
    rng = np.random.default_rng(3)
    f = _feats(*_bits(rng, 4, 120, 64))
    idx = torch.from_numpy(rng.permutation(120)[:37])
    sub = subset_rows(f, idx)
    assert torch.equal(sub.words_s, f.words_s[:, idx])
    assert torch.equal(sub.bits_s, unpack_bits8(sub.words_s))
    assert torch.equal(sub.bits_s, f.bits_s[:, idx])
    assert torch.equal(sub.na, f.na[:, idx])
    assert sub.bits_s.is_contiguous()
    assert sub.bits_t is f.bits_t and sub.words_t is f.words_t


def _sweep_args(rng, S, C, feats, wed=0.7, wfd=0.3):
    t = torch.from_numpy
    kp_s = t(rng.uniform(-10, 10, (S, 3)).astype(np.float32))
    kp_t = t(rng.uniform(-10, 10, (C, 3)).astype(np.float32))
    ms, mt = t(rng.random(S) < 0.9), t(rng.random(C) < 0.9)
    prices = t(rng.uniform(0, 3, C).astype(np.float32))
    acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S), -1)
    acol[::11] = 2**30
    return (kp_s, kp_t, feats, ms, mt, prices, t(acol), wed, wfd, 0.08)


def _desc_feats(rng, S, C, D=33):
    t = torch.from_numpy
    desc_t = rng.gamma(2.0, 5.0, (C, D)).astype(np.float32)
    desc_s = desc_t[rng.integers(0, C, S)] + rng.normal(
        0, 3.0, (S, D)).astype(np.float32)
    return make_desc_features(t(desc_s), t(desc_t))


@pytest.mark.parametrize("lane", ["bsc", "none", "similarity"])
def test_statistics_free_sweep(lane):
    """``with_stats=False``: the same top-2 and vsel, NaN statistics, and a
    caller that reads them raises."""
    rng = np.random.default_rng(5)
    S, C = 150, 200
    feats, w = {"bsc": lambda: (_feats(*_bits(rng, 4, S, C)), (0.7, 0.3)),
                "none": lambda: (NoFeatures(S), (1.0, 0.0)),
                "similarity": lambda: (_desc_feats(rng, S, C),
                                       (1.0, 1.0 / 3.0))}[lane]()
    a = _sweep_args(rng, S, C, feats, *w)
    full = stream_sweep_plain(*a, tc=64)
    bare = stream_sweep(*a, with_stats=False)
    for k in ("v1", "j1", "v2", "j2", "vsel"):
        assert torch.equal(getattr(full, k), getattr(bare, k))
    for k in STAT_FIELDS:
        assert torch.isnan(getattr(bare, k))
        assert torch.isfinite(getattr(full, k))
    assert float(full.cnt) > 0
    mean, std = sweep_moments(full)
    assert float(mean) > 0 and float(std) > 0
    with pytest.raises(ValueError, match="with_stats=False"):
        sweep_moments(bare)


@pytest.mark.parametrize("lane", ["bsc", "none", "similarity"])
def test_sweep_target_checks_what_it_was_made_from(lane):
    """A ``SweepTarget`` serves only the columns, factors and mask it was
    made from, unchanged: other tensors of the same shapes, or an in-place
    write to its own, raise (the kernel would read stale target rows)."""
    rng = np.random.default_rng(13)
    S, C = 96, 128
    make = {"bsc": lambda: _feats(*_bits(rng, 2, S, C)),
            "none": lambda: NoFeatures(S),
            "similarity": lambda: _desc_feats(rng, S, C)}[lane]
    feats = make()
    a = _sweep_args(rng, S, C, feats)
    kp_t, mask_t = a[1], a[4]
    tg = sweep_target(kp_t, feats, mask_t)
    check_target(tg, kp_t, feats, mask_t)
    check_target(tg, kp_t, subset_rows(feats, torch.arange(0, S, 2)),
                 mask_t)
    with pytest.raises(ValueError, match="target was made from other"):
        check_target(tg, kp_t.clone(), feats, mask_t)
    with pytest.raises(ValueError, match="target was made from other"):
        check_target(tg, kp_t, feats, mask_t.clone())
    if lane != "none":
        with pytest.raises(ValueError, match="target was made from other"):
            check_target(tg, kp_t, make(), mask_t)
    mask_t[0] = ~mask_t[0]
    with pytest.raises(ValueError, match="target was made from other"):
        check_target(tg, kp_t, feats, mask_t)


def _spy_solve(monkeypatch, rng, S, C, feats, wed, wfd):
    """A streaming solve with its sweeps spied on: (rows, with_stats) of
    each sweep in order."""
    from ghicp_tpu_torch.matching import stream_auction as sa
    a = _sweep_args(rng, S, C, feats)
    seen = []

    def spy(*args, **kw):
        seen.append((args[0].shape[0], kw.get("with_stats", True)))
        return stream_sweep(*args, **kw)

    monkeypatch.setattr(sa, "stream_sweep", spy)
    sa.stream_solve(a[0], a[1], feats, torch.ones(S, dtype=torch.bool),
                    torch.ones(C, dtype=torch.bool), wed, wfd, 0.1,
                    lambda m, s: m - s, eps_final=0.01, rel_eps=1.0 / 64,
                    max_sweeps=64, p0=torch.zeros(C), price_uncertainty=3e38,
                    acol0=torch.full((S,), -1, dtype=torch.int64),
                    pen_prev=0.0, open_cap=64)
    return seen


def test_solve_reads_statistics_of_sweep_zero_only(monkeypatch):
    """The streaming solve asks for the statistics on its sweep 0 and for
    none on its bidding sweeps (full and compacted)."""
    rng = np.random.default_rng(9)
    S, C = 192, 256
    seen = _spy_solve(monkeypatch, rng, S, C, _feats(*_bits(rng, 4, S, C)),
                      0.6, 0.4)
    assert seen[0] == (S, True)
    assert len(seen) > 2 and all(not ws for _, ws in seen[1:])
    assert any(rows == RT for rows, _ in seen[1:])


def test_solve_reads_statistics_of_sweep_zero_only_on_fpfh(monkeypatch):
    """The same on the similarity (FPFH) lane: its bidding sweeps, full and
    compacted, ask for no statistics."""
    rng = np.random.default_rng(19)
    S, C = 192, 256
    seen = _spy_solve(monkeypatch, rng, S, C, _desc_feats(rng, S, C), 1.0,
                      1.0 / 3.0)
    assert seen[0] == (S, True)
    assert len(seen) > 2 and all(not ws for _, ws in seen[1:])
    assert any(rows == RT for rows, _ in seen[1:])


def _single_pass(v):
    """The lexicographic top-2 (value desc, column asc) of each row, with the
    initial (NEG, 0) twice, by sorting."""
    S, C = v.shape
    cols = torch.arange(C).expand(S, C)
    vals = torch.cat([v, torch.full((S, 2), NEG)], dim=1)
    ids = torch.cat([cols, torch.zeros((S, 2), dtype=torch.int64)], dim=1)
    key = torch.argsort(ids, dim=1, stable=True)
    vals, ids = vals.gather(1, key), ids.gather(1, key)
    order = torch.argsort(-vals, dim=1, stable=True)
    vals, ids = vals.gather(1, order), ids.gather(1, order)
    return vals[:, 0], ids[:, 0], vals[:, 1], ids[:, 1]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), C=st.integers(1, 40),
       n_parts=st.integers(1, 8), levels=st.integers(1, 4))
def test_lex_top2_merge_is_order_free(seed, C, n_parts, levels):
    """Column subsets folded in a random order, with planted ties (values
    from a few levels, masked NEG entries), give the single-pass top-2."""
    rng = np.random.default_rng(seed)
    S = 6
    v = torch.from_numpy(rng.integers(0, levels, (S, C)).astype(np.float32))
    v[torch.from_numpy(rng.random((S, C)) < 0.2)] = NEG
    part = rng.integers(0, n_parts, C)
    state = _top2_init(S, "cpu")
    for p in rng.permutation(n_parts):
        cols = np.nonzero(part == p)[0]
        if cols.size:
            state = _merge_top2(state, v[:, cols], torch.from_numpy(cols))
    want = _single_pass(v)
    for a, b in zip(state, want):
        assert torch.equal(a, b)
    # and the merge of two partial top-2s is symmetric
    half = C // 2
    s1 = _merge_top2(_top2_init(S, "cpu"), v[:, :half], 0) if half else \
        _top2_init(S, "cpu")
    s2 = _merge_top2(_top2_init(S, "cpu"), v[:, half:], half)
    for a, b, c in zip(lex_merge_top2(s1, s2), lex_merge_top2(s2, s1), want):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_kernel_arithmetic_identities():
    """The Hamming kernel reads FD from BIAS + min_v (na_v - 2 a_v.b) as the
    float 8389120 + that value (exact over its range), spreads a packed word
    a nibble at a time into {0, 1} bytes by one product, and carries the
    price 3e38 at masked columns, where -CD - p rounds to the initial -3e38
    for any CD the lanes produce."""
    BIAS, BIAS_F = 0x4B000200, np.float32(8389120.0)
    # na_v - 2 a_v.b lies in [-|b|, |a_v|], within [-448, 448]
    h = np.arange(-BIT_ROW, BIT_ROW + 1, dtype=np.int32)
    got = (h + BIAS).astype(np.int32).view(np.float32) - BIAS_F
    np.testing.assert_array_equal(got, h.astype(np.float32))
    nib = np.arange(16, dtype=np.uint32)
    spread = ((nib * np.uint32(0x00204081)) & np.uint32(0x01010101))
    want = sum(((nib >> k) & 1) << (8 * k) for k in range(4))
    np.testing.assert_array_equal(spread, want)
    cd = np.float32(np.concatenate([[0.0], np.geomspace(1e-30, 1e9, 200)]))
    out = (-cd).astype(np.float32) - np.float32(3.0e38)
    assert (out == np.float32(-3.0e38)).all()
    assert np.float32(-3.0e38) == np.float32(NEG)


@pytest.mark.parametrize("S,C,rows,cols", [
    (51200, 51200, RT, HAM_TC), (2048, 51200, RT, HAM_TC),
    (51200, 51200, NONE_RT, NONE_TC), (2048, 51200, NONE_RT, NONE_TC),
    (8192, 8192, RT, HAM_TC), (100, 777, RT, HAM_TC), (1, 1, RT, HAM_TC),
    (51200, 51200, DESC_RT, desc_tile_cols(33)),
    (2048, 51200, DESC_RT, desc_tile_cols(33)),
    (8192, 51200, DESC_RT, desc_tile_cols(135))])
def test_column_splits_leave_no_range_empty(S, C, rows, cols):
    n_ct = -(-C // cols)
    for per_sm in (2, 16):
        cs = column_splits(S, C, 132, rows, cols, per_sm)
        tps = -(-n_ct // cs)
        assert 1 <= cs <= n_ct and (cs - 1) * tps < n_ct


# ---------------------------------------------------------------------------
# K5-none-col: a model of none_kernel<STATS, true>'s blocking
# ---------------------------------------------------------------------------

_NO_KEY = 0xFFFFFFFF


def _bits32(x):
    return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def _none_col_model(args, splits, rng):
    """none_kernel<STATS, true> step by step: blocks of NONE_RT rows (lane
    l, register r: row0 + l + 32 r), column splits of whole tiles, each
    tile's valid columns compacted in order, warp w walking compacted
    positions w, w + 4, ...; per column a lane's least CD over its rows (a
    masked row's CD NaN, skipped as fminf does), the warp's least bits, the
    lowest row at them, the key folded into the global array; per row the
    top-2 of each warp's columns merged over warps and splits.  A warp
    none of whose lanes reaches the column's key as staged with the tile
    (the current key or, as a tile staged a tile ahead may hold, an older
    one) skips the column.  Blocks, warps and splits run in shuffled
    orders.  Returns (v1, j1, v2, j2, cnt, cmin, crow, columns skipped)."""
    from ghicp_tpu_torch.ops.cost_kernel import _f32, _factors, factor_ed
    from ghicp_tpu_torch.ops.stream_kernel import _COL_KEY0, NO_ROW
    kp_s, kp_t, _, ms, mt, prices, _, wed, _, scale = args
    S, C = kp_s.shape[0], kp_t.shape[0]
    ks, kt = _factors(kp_s), _factors(kp_t)
    n_rb, n_ct = -(-S // NONE_RT), -(-C // NONE_TC)
    tps = -(-n_ct // splits)
    colkey = np.full(C, _COL_KEY0, np.uint64)
    part = {}
    cnt = skipped = 0
    wed32 = np.float32(_f32(wed))
    for b, y in rng.permutation([(b, y) for b in range(n_rb)
                                 for y in range(splits)]):
        rows = b * NONE_RT + np.arange(NONE_RT)     # index 32 r + lane
        live = (rows < S) & ms.numpy()[np.minimum(rows, S - 1)]
        rows_in = np.minimum(rows, S - 1)
        state = _top2_init(NONE_RT, "cpu")
        nvalid = 0
        older = colkey.copy()
        for tile in range(y * tps, min(n_ct, (y + 1) * tps)):
            cols = tile * NONE_TC + np.arange(NONE_TC)
            cols = cols[cols < C]
            comp = cols[mt.numpy()[cols]]       # compacted, increasing
            nvalid += comp.size
            if not comp.size:
                continue
            staged = (older if rng.random() < 0.5 else colkey)[comp] >> \
                np.uint64(32)
            ed = factor_ed(ks[rows_in], kt[comp], scale).numpy()
            cd = np.where(live[:, None], wed32 * ed, np.float32(np.nan))
            v = torch.from_numpy(np.where(
                live[:, None], -cd - prices.numpy()[comp][None, :],
                np.float32(NEG)).astype(np.float32))
            tops = []
            for w in rng.permutation(4):
                qs = np.arange(w, comp.size, 4)
                if not qs.size:
                    continue
                tops.append(_merge_top2(_top2_init(NONE_RT, "cpu"), v[:, qs],
                                        torch.from_numpy(comp[qs])))
                c4 = cd[:, qs].reshape(4, 32, qs.size)    # [r, lane, q]
                lane_min = np.fmin.reduce(c4, axis=0)
                bits = np.where(lane_min == lane_min,
                                _bits32(lane_min + np.float32(0.0)),
                                _NO_KEY)
                reach = (bits <= staged[qs][None, :]).any(axis=0)   # vote
                skipped += int((~reach).sum())
                wm = bits.min(axis=0)                      # over the warp
                mf = np.asarray(wm.astype(np.uint32)).view(np.float32)
                rowid = (b * NONE_RT + np.arange(32)[None, :, None]
                         + 32 * np.arange(4)[:, None, None])
                hit = c4 == mf[None, None, :]
                rr = np.where(hit, rowid, _NO_KEY).min(axis=0)  # lowest r
                wrow = rr.min(axis=0).astype(np.uint64)
                ok = reach & (wm != _NO_KEY)
                key = (wm << np.uint64(32)) | wrow
                tgt = comp[qs][ok]
                colkey[tgt] = np.minimum(colkey[tgt], key[ok])
            for t in tops:
                state = lex_merge_top2(state, t)
        cnt += int(live.sum()) * nvalid
        part[(b, y)] = (state, rows, live)
    v1, j1, v2, j2 = _top2_init(S, "cpu")
    for y in rng.permutation(splits):
        sv1, sj1, sv2, sj2 = _top2_init(S, "cpu")
        for b in range(n_rb):
            (a1, b1, a2, b2), rows, live = part[(b, y)]
            keep = torch.from_numpy(live)
            idx = torch.from_numpy(rows[live])
            sv1[idx], sj1[idx], sv2[idx], sj2[idx] = (a1[keep], b1[keep],
                                                      a2[keep], b2[keep])
        v1, j1, v2, j2 = lex_merge_top2((v1, j1, v2, j2),
                                        (sv1, sj1, sv2, sj2))
    cmin = (colkey >> np.uint64(32)).astype(np.uint32).view(np.float32)
    crow = (colkey & np.uint64(_M32_NP)).astype(np.int64)
    assert ((crow == NO_ROW) == (cmin == np.float32(3e38))).all()
    return v1, j1, v2, j2, cnt, cmin, crow, skipped


_M32_NP = 0xFFFFFFFF


def _none_col_args(rng, S, C, tie_block: bool):
    a = list(_sweep_args(rng, S, C, NoFeatures(S), 1.0, 0.0))
    if tie_block:
        # row 2k + 1 copies row 2k (coordinates and mask): every column's
        # least CD sits at two rows, and the lower must win
        kp_s, ms = a[0].clone(), a[3].clone()
        n = S // 2
        kp_s[1::2] = kp_s[0::2][:n]
        ms[1::2] = ms[0::2][:n]
        a[0], a[3] = kp_s, ms
    return tuple(a)


@pytest.mark.parametrize("S,C,splits,tie_block", [
    (300, 400, 1, False), (300, 400, 3, False), (1024, 640, 2, True),
    (257, 129, 2, True)])
def test_none_col_blocking_model_matches_plain(S, C, splits, tie_block):
    """The blocking of K5-none-col (rows NR at a time, compacted columns, a
    column's key reduced over a warp's lanes, then over row blocks and
    column splits, in shuffled orders) gives the plain version's top-2,
    count and cmin / crow bit for bit, with masked rows and columns and on
    a tie block."""
    rng = np.random.default_rng(S + C + splits)
    a = _none_col_args(rng, S, C, tie_block)
    want = stream_sweep_plain(*a, tc=96, col_side=True)
    v1, j1, v2, j2, cnt, cmin, crow, skipped = _none_col_model(a, splits,
                                                              rng)
    assert torch.equal(v1, want.v1) and torch.equal(j1, want.j1)
    assert torch.equal(v2, want.v2) and torch.equal(j2, want.j2)
    assert cnt == int(want.cnt)
    np.testing.assert_array_equal(cmin.view(np.uint32),
                                  want.cmin.numpy().view(np.uint32))
    np.testing.assert_array_equal(crow, want.crow.numpy())
    valid = crow < 2**30
    assert valid.sum() > 0.5 * C
    if tie_block:
        assert (crow[valid] % 2 == 0).all()
    # the staged keys do prune: later row blocks rarely improve a column
    assert skipped > 0


def test_none_col_plain_is_the_streaming_nnr_sweep():
    """The engine's streaming NNR sweep on the none lane is the plain
    K5-none-col on the CPU (statistics on), and its cmin / crow answer the
    column side of the dense CD."""
    rng = np.random.default_rng(21)
    S, C = 200, 260
    a = _none_col_args(rng, S, C, True)
    got = stream_sweep(*a, col_side=True)
    from ghicp_tpu_torch.ops.cost_kernel import _factors, factor_ed
    cd = np.float32(1.0) * factor_ed(_factors(a[0]), _factors(a[1]),
                                     a[9]).numpy()
    m = a[3].numpy()[:, None] & a[4].numpy()[None, :]
    cdm = np.where(m, cd, np.float32(3e38))
    want_min = cdm.min(axis=0)
    want_row = np.where(cdm == want_min[None, :], np.arange(S)[:, None],
                        2**30).min(axis=0)
    want_row = np.where(want_min < np.float32(3e38), want_row, 2**30)
    np.testing.assert_array_equal(got.cmin.numpy(), want_min)
    np.testing.assert_array_equal(got.crow.numpy(), want_row)
    assert np.isfinite(float(got.cd_sum)) and float(got.cnt) == m.sum()


# ---------------------------------------------------------------------------
# K5-col: a model of ham_kernel<V, true, true>'s column side
# ---------------------------------------------------------------------------

def _ham_col_model(args, splits, rng):
    """ham_kernel's column side step by step, in the wgmma m64nN
    accumulator layout: blocks of RT rows, column splits of whole tiles of
    HAM_TC columns; warpgroup w finishes columns 32 w .. 32 w + 31 of a
    tile, its warp q rows 16 q .. 16 q + 15, where lane (g, t4) holds rows
    16 q + g and + 8 and columns 8 k + 2 t4 + e.  Per column, a lane's
    least CD over its two rows (a masked row's CD NaN, skipped as fminf
    does), the 8 lanes of equal t4 the least bits and the lowest row at
    them, into the block's slot of the column unless the warp's least does
    not reach the key staged with the tile (the current key or an older
    one), then the slot into the global array after the tile.  Blocks,
    splits, warpgroups and warps run in shuffled orders.  Returns (cmin,
    crow, columns skipped by the vote)."""
    from ghicp_tpu_torch.ops.cost_kernel import _factors, factor_cost
    from ghicp_tpu_torch.ops.stream_kernel import _COL_KEY0, NO_ROW
    kp_s, kp_t, feats, ms, mt, prices, _, wed, wfd, scale = args
    S, C = kp_s.shape[0], kp_t.shape[0]
    # FD as the tensor cores sum it: integers over the unpacked bits
    dot = torch.einsum("vsk,ck->vsc", feats.bits_s.to(torch.int32),
                       feats.bits_t.to(torch.int32))
    fd = (feats.na.to(torch.int32)[:, :, None]
          + feats.nb.to(torch.int32)[None, None] - 2 * dot).amin(dim=0)
    cd_all = factor_cost(_factors(kp_s), _factors(kp_t), fd.to(torch.float32),
                         wed, wfd, scale)[1].numpy()
    cd_all = np.where(ms.numpy()[:, None], cd_all, np.float32(np.nan))
    n_rb, n_ct = -(-S // RT), -(-C // HAM_TC)
    tps = -(-n_ct // splits)
    colkey = np.full(C, _COL_KEY0, np.uint64)
    skipped = 0
    g, ri = np.arange(8)[:, None], np.arange(2)[None, :]
    for b, y in rng.permutation([(b, y) for b in range(n_rb)
                                 for y in range(splits)]):
        older = colkey.copy()
        for tile in range(y * tps, min(n_ct, (y + 1) * tps)):
            staged = (older if rng.random() < 0.5 else colkey) >> \
                np.uint64(32)
            slot = np.full(HAM_TC, 2**64 - 1, np.uint64)
            for w in rng.permutation(2):
                for q in rng.permutation(4):
                    rows = b * RT + 16 * q + g + 8 * ri      # [g, ri]
                    rin = rows < S
                    for k in range(4):
                        for t4 in range(4):
                            for e in range(2):
                                qc = 32 * w + 8 * k + 2 * t4 + e
                                col = tile * HAM_TC + qc
                                if col >= C or not mt[col]:
                                    continue
                                cd = np.where(rin, cd_all[np.minimum(
                                    rows, S - 1), col], np.float32(np.nan))
                                lane_min = np.fmin.reduce(cd, axis=1)
                                bits = np.where(
                                    lane_min == lane_min,
                                    (lane_min + np.float32(0.0)).astype(
                                        np.float32).view(np.uint32),
                                    _NO_KEY).astype(np.uint64)
                                wm = bits.min()
                                if wm > staged[col]:        # the vote
                                    skipped += 1
                                    continue
                                mf = np.uint32(wm).view(np.float32)
                                rr = np.where(cd == mf, rows, _NO_KEY).min()
                                key = (wm << np.uint64(32)) | np.uint64(rr)
                                slot[qc] = min(slot[qc], key)
            cols = tile * HAM_TC + np.arange(HAM_TC)
            ok = (cols < C) & (slot != np.uint64(2**64 - 1))
            colkey[cols[ok]] = np.minimum(colkey[cols[ok]], slot[ok])
    cmin = (colkey >> np.uint64(32)).astype(np.uint32).view(np.float32)
    crow = (colkey & np.uint64(_M32_NP)).astype(np.int64)
    assert ((crow == NO_ROW) == (cmin == np.float32(3e38))).all()
    return cmin, crow, skipped


@pytest.mark.parametrize("V,S,C,splits,tie_block", [
    (4, 200, 300, 1, False), (2, 256, 200, 3, True), (1, 150, 140, 2, True)])
def test_ham_col_model_matches_plain(V, S, C, splits, tie_block):
    """The Hamming lane's column side in ham_kernel's accumulator layout
    (two rows a lane, 8 lanes a column, four warps, two warpgroups; keys
    folded into a block slot, then the global array, in shuffled orders,
    after the staged-key vote) gives the plain cmin / crow bit for bit,
    with masked rows and columns, and on a block of duplicated row pairs
    the lower row of each tie."""
    rng = np.random.default_rng(V * 100 + S + splits)
    bs, bt = _bits(rng, V, S, C)
    if tie_block:
        bs[:, 1::2] = bs[:, 0::2][:, :S // 2]
    feats = _feats(bs, bt)
    a = list(_sweep_args(rng, S, C, feats))
    if tie_block:
        kp_s, ms = a[0].clone(), a[3].clone()
        kp_s[1::2] = kp_s[0::2][:S // 2]
        ms[1::2] = ms[0::2][:S // 2]
        a[0], a[3] = kp_s, ms
    a = tuple(a)
    want = stream_sweep_plain(*a, tc=96, col_side=True)
    cmin, crow, skipped = _ham_col_model(a, splits, rng)
    np.testing.assert_array_equal(cmin.view(np.uint32),
                                  want.cmin.numpy().view(np.uint32))
    np.testing.assert_array_equal(crow, want.crow.numpy())
    valid = crow < 2**30
    assert valid.sum() > 0.5 * C
    if tie_block:
        assert (crow[valid] % 2 == 0).all()
    assert skipped > 0
