"""The Hamming lane past four variants (``hamw_kernel``) modelled on the CPU:
its blocking, step by step in numpy, against ``stream_sweep_plain``, and
the Python helpers that choose its rows, wgmma N and column splits.

The model follows the kernel: a block owns ``rows`` source rows and
keeps B, -2 x their bit rows of every variant padded to VP with variant 0
(n = rows v + r), for the whole sweep; A is a 64-column tile of the
target's bit rows (``bit_tiles``); warpgroup w takes the range's 64-column
tiles w, w + 2, ...; the wgmma m64nN accumulator layout puts element
4 j + 2 i + e of lane (g, t4) of warp q at column 16 q + g + 8 i and N
index 8 j + 2 t4 + e; the variant minimum is read from a lane's own
registers; a row's top-2 is a running state of each lane, merged over the
lanes and warps that share the row; a column's key reduces over a lane's
rows and its four t4 lanes into one atomic a column and block, after the
staged-key vote.  Blocks, splits, warpgroups and lanes run in shuffled
orders."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.ops.cost_kernel import _factors, factor_cost
from ghicp_tpu_torch.ops.stream_kernel import (
    _COL_KEY0, BIT_ROW, HAM_TC, KERNEL_MAX_VARIANTS, NEG, NO_ROW,
    WIDE_SMEM_MAX, WIDE_WIDTHS, bit_tiles, is_wide, make_stream_features,
    stream_sweep_plain, wide_shape, wide_smem_bytes, wide_splits)

torch.set_num_threads(1)
N_BITS = 441
BIAS = 0x4B000200                 # csrc/stream.cu ham::BIAS
BIAS_F = np.float32(8389120.0)    # the float whose bits BIAS is
NO_KEY = 0xFFFFFFFF
STREAM_CU = (Path(__file__).resolve().parent.parent / "ghicp_tpu_torch"
             / "csrc" / "stream.cu")


def _lex_better(va, ja, vb, jb):
    return va > vb or (va == vb and ja < jb)


def _lex_merge(a, b):
    """csrc/stream.cu lex_merge on (v1, j1, v2, j2) tuples."""
    if _lex_better(b[0], b[1], a[0], a[1]):
        k = _lex_better(a[0], a[1], b[2], b[3])
        return (b[0], b[1]) + ((a[0], a[1]) if k else (b[2], b[3]))
    k = _lex_better(b[0], b[1], a[2], a[3])
    return (a[0], a[1]) + ((b[0], b[1]) if k else (a[2], a[3]))


def _push(t, val, col):
    """csrc/stream.cu top2_push: columns come in increasing order."""
    if val > t[2]:
        return (val, col, t[0], t[1]) if val > t[0] else (t[0], t[1], val,
                                                           col)
    return t


def _problem(rng, V, S, C, tied):
    """A sweep's arguments with masked rows and columns; ``tied`` copies
    row 2k into row 2k + 1 (coordinates, every variant, mask) and column
    2k into column 2k + 1 (coordinates, bits, mask, price), so that exact
    ties fall between rows (the column side) and between columns (the
    top-2)."""
    bs = (rng.random((V, S, N_BITS)) < 0.3).astype(np.float32)
    bt = (rng.random((1, C, N_BITS)) < 0.3).astype(np.float32)
    kp_s = rng.uniform(-10, 10, (S, 3)).astype(np.float32)
    kp_t = rng.uniform(-10, 10, (C, 3)).astype(np.float32)
    ms, mt = rng.random(S) < 0.85, rng.random(C) < 0.85
    prices = rng.uniform(0, 3, C).astype(np.float32)
    if tied:
        for x in (bs, kp_s[None], ms[None]):
            x[:, 1::2] = x[:, 0::2][:, :S // 2]
        for x in (bt, kp_t[None], mt[None], prices[None]):
            x[:, 1::2] = x[:, 0::2][:, :C // 2]
    acol = np.where(rng.random(S) < 0.7, rng.integers(0, C, S), -1)
    feats = make_stream_features(pack_bits(torch.from_numpy(bs)),
                                 pack_bits(torch.from_numpy(bt)))
    t = torch.from_numpy
    return (t(kp_s), t(kp_t), feats, t(ms), t(mt), t(prices), t(acol), 0.7,
            0.3, 0.08)


def _lane_rows(rows, t4):
    """The rows of a block lane t4 holds: 8 h + 2 t4 + e, in the kernel's
    order lr = 2 h + e (increasing)."""
    return [8 * (lr >> 1) + 2 * t4 + (lr & 1) for lr in range(rows // 4)]


def _wide_model(args, V, splits, rng):
    """hamw_kernel's sweep step by step (see the module head).  Returns
    (v1, j1, v2, j2) and (cmin, crow, columns skipped by the vote), the
    count and the CD sum (float32 a tile and lane, then float64)."""
    kp_s, kp_t, feats, ms, mt, prices = (x.numpy() if torch.is_tensor(x)
                                         else x for x in args[:6])
    S, C = kp_s.shape[0], kp_t.shape[0]
    rows, vp, n = wide_shape(V)
    lr_n, hg = rows // 4, rows // 8
    bits_s = feats.bits_s.numpy().astype(np.int64)
    bits_t = feats.bits_t.numpy().astype(np.int64)
    na = feats.na.numpy().astype(np.int64)
    nb = feats.nb.numpy()
    n_rb, n_ct = -(-S // rows), -(-C // HAM_TC)
    tps = -(-n_ct // splits)
    blocks = [(b, y) for b in range(n_rb) for y in range(splits)
              if y * tps < n_ct]

    # ---- the products and the register-local variant minimum ----
    fd = np.full((S, C), np.nan, np.float32)
    for b, y in blocks:
        r_ids = b * rows + np.arange(n) % rows
        v_ids = np.where(np.arange(n) // rows < V, np.arange(n) // rows, 0)
        inside = r_ids < S
        # -2 x the bits, so that the products sum -2 a_v.b
        B = -2 * np.where(inside[:, None],
                          bits_s[v_ids, np.minimum(r_ids, S - 1)], 0)
        s_na = BIAS + np.where(inside, na[v_ids, np.minimum(r_ids, S - 1)], 0)
        for tile in range(y * tps, min(n_ct, (y + 1) * tps)):
            cols = tile * HAM_TC + np.arange(HAM_TC)
            A = np.where((cols < C)[:, None], bits_t[np.minimum(cols, C - 1)],
                         0)
            acc = A @ B.T                                    # [64, N]
            for q in range(4):
                for g in range(8):
                    for t4 in range(4):
                        # the lane's registers in the m64nN layout
                        d = [acc[16 * q + g + 8 * ((k % 4) >> 1),
                                 8 * (k // 4) + 2 * t4 + (k & 1)]
                             for k in range(n // 2)]
                        for lr, r in enumerate(_lane_rows(rows, t4)):
                            for c in range(2):
                                # the kernel's register index of (v, lr, c)
                                hb = min(int(s_na[rows * v + r]) + d[
                                    4 * (hg * v + (lr >> 1)) + (lr & 1)
                                    + 2 * c] for v in range(vp))
                                row = b * rows + r
                                col = tile * HAM_TC + 16 * q + g + 8 * c
                                if row < S and col < C:
                                    assert np.isnan(fd[row, col])
                                    fd[row, col] = (np.int32(hb).view(
                                        np.float32) - BIAS_F) + nb[col]
    assert not np.isnan(fd).any()        # every pair exactly once
    ed, cd = (x.numpy() for x in factor_cost(
        _factors(args[0]), _factors(args[1]), torch.from_numpy(fd),
        args[7], args[8], args[9]))

    # ---- the epilogue: per-lane top-2, statistics, column keys ----
    init = (np.float32(NEG), 0, np.float32(NEG), 0)
    parts = [[] for _ in range(S)]
    colkey = np.full(C, _COL_KEY0, np.uint64)
    skipped, cnt, cd_sum = 0, 0, 0.0
    price = np.where(mt, prices, np.float32(3e38)).astype(np.float32)
    for b, y in rng.permutation(np.array(blocks)):
        older = colkey.copy()
        t0, t1 = y * tps, min(n_ct, (y + 1) * tps)
        live = [(b * rows + r < S) and bool(ms[b * rows + r])
                for r in range(rows)]
        cnt += sum(live) * int(mt[t0 * HAM_TC:t1 * HAM_TC].sum())
        for w in rng.permutation(2):
            for q in rng.permutation(4):
                for t4 in rng.permutation(4):
                    lrs = _lane_rows(rows, t4)
                    for g in rng.permutation(8):
                        st = [init] * len(lrs)
                        for tile in range(t0 + w, t1, 2):
                            part = np.float32(0.0)
                            for c in range(2):
                                col = tile * HAM_TC + 16 * q + g + 8 * c
                                if col >= C:
                                    continue
                                for lr, r in enumerate(lrs):
                                    row = b * rows + r
                                    if row >= S:
                                        continue
                                    v = np.float32(-cd[row, col]) - price[col]
                                    st[lr] = _push(st[lr], v, col)
                                    if mt[col] and live[r]:
                                        part = np.float32(part + cd[row, col])
                            cd_sum += float(part)
                        for lr, r in enumerate(lrs):
                            if b * rows + r < S:
                                parts[b * rows + r].append(st[lr])
                # the column side of this warp's columns, tile by tile
                for tile in range(t0 + w, t1, 2):
                    staged = (older if rng.random() < 0.5 else colkey) >> \
                        np.uint64(32)
                    for c in range(2):
                        keys = {}
                        for g in range(8):
                            col = tile * HAM_TC + 16 * q + g + 8 * c
                            if col >= C:
                                continue
                            for t4 in range(4):
                                cds = np.float32([
                                    cd[b * rows + r, col]
                                    if b * rows + r < S and live[r]
                                    else np.nan for r in _lane_rows(rows, t4)])
                                mn = np.fmin.reduce(cds)
                                mb = (NO_KEY if np.isnan(mn) else int(
                                    np.float32(mn + np.float32(0.0)).view(
                                        np.uint32)))
                                keys[(g, t4)] = (col, mb, cds)
                        vote = any(mt[col] and mb <= staged[col]
                                   for col, mb, _ in keys.values())
                        if not vote:
                            skipped += 1
                            continue
                        for g in range(8):
                            if (g, 0) not in keys:
                                continue
                            col = keys[(g, 0)][0]
                            wm = min(keys[(g, t4)][1] for t4 in range(4))
                            mf = np.uint32(wm).view(np.float32)
                            rr = min((b * rows + r for t4 in range(4)
                                      for r, x in zip(_lane_rows(rows, t4),
                                                      keys[(g, t4)][2])
                                      if x == mf), default=NO_KEY)
                            if mt[col] and wm <= staged[col]:
                                key = np.uint64((wm << 32) | rr)
                                colkey[col] = min(colkey[col], key)
    # the row top-2 over the lanes and warps (and splits), shuffled
    top = []
    for r in range(S):
        t = init
        for i in rng.permutation(len(parts[r])):
            t = _lex_merge(t, parts[r][i])
        top.append(t if ms[r] else init)
    cmin = (colkey >> np.uint64(32)).astype(np.uint32).view(np.float32)
    crow = (colkey & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return top, (cmin, crow, skipped), cnt, cd_sum


@pytest.mark.parametrize("V,S,C,splits,tied", [
    (3, 40, 150, 1, True), (5, 37, 140, 2, False), (6, 48, 200, 1, True),
    (12, 33, 190, 2, True), (28, 20, 130, 1, True)])
def test_wide_model_matches_plain(V, S, C, splits, tied):
    """hamw_kernel's blocking gives the plain sweep's top-2 (values and
    columns), cmin / crow and count bit for bit at V = 3, 5, 6, 12 and
    28, with masked rows and columns and tied row and column pairs: the
    lowest column of a tie stays first, the lower row of a tie wins its
    column."""
    rng = np.random.default_rng(1000 + 10 * V + S)
    args = _problem(rng, V, S, C, tied)
    want = stream_sweep_plain(*args, tc=96, col_side=True)
    top, (cmin, crow, skipped), cnt, cd_sum = _wide_model(args, V, splits,
                                                          rng)
    for k, name in enumerate(("v1", "j1", "v2", "j2")):
        got = np.array([t[k] for t in top])
        w = getattr(want, name).numpy()
        if name.startswith("v"):
            np.testing.assert_array_equal(got.astype(np.float32).view(
                np.uint32), w.view(np.uint32))
        else:
            np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(cmin.view(np.uint32),
                                  want.cmin.numpy().view(np.uint32))
    np.testing.assert_array_equal(crow, want.crow.numpy())
    assert cnt == float(want.cnt)
    np.testing.assert_allclose(cd_sum, float(want.cd_sum), rtol=1e-5)
    valid = crow < NO_ROW
    assert valid.sum() > 0.5 * C and skipped > 0
    if tied:
        assert (crow[valid] % 2 == 0).all()
        # tied columns: the pair's first stays first (or second)
        j1, v1, v2 = (np.array([t[k] for t in top]) for k in (1, 0, 2))
        both = (v1 == v2) & (v1 > np.float32(NEG))
        assert both.any() and (j1[both] % 2 == 0).all()


def test_wide_shapes_fit_the_block():
    """(rows, VP, N) for every V in 3 .. 28: V padded to the fewest of the
    instantiations' widths, N a wgmma N for .s8 (a multiple of 16 to 256)
    with a lane's rows x variants in its accumulators, shared memory
    within the 227 KB budget less the static arrays; the CUDA source
    instantiates exactly these (rows, VP) and takes rows the same way."""
    src = STREAM_CU.read_text()
    inst = {tuple(map(int, m)) for m in re.findall(
        r"launch_hamw<(\d+), (\d+), STATS, COL>", src)}
    assert str(WIDE_SMEM_MAX) == "230400" and "232448 - 2048" in src
    seen = set()
    for V in range(3, KERNEL_MAX_VARIANTS + 1):
        rows, vp, n = wide_shape(V)
        assert is_wide(V) == (V != 4)
        assert vp in WIDE_WIDTHS and vp >= V
        assert vp == min(w for w in WIDE_WIDTHS if w >= V)
        assert rows in (8, 16) and n == rows * vp
        assert n % 16 == 0 and n <= 256
        assert n // 2 <= 112            # accumulators a thread
        smem = wide_smem_bytes(V)
        assert smem == (n * BIT_ROW + 4 * HAM_TC * BIT_ROW
                        + 6 * HAM_TC * 32 + 4 * n)
        assert smem <= WIDE_SMEM_MAX < 227 * 1024
        seen.add((rows, vp))
    assert seen == inst
    assert "rows_of(int V) { return V <= 12 ? 16 : 8; }" in src


@pytest.mark.parametrize("S,C", [(2048, 4096), (4096, 4096), (8192, 8192),
                                 (64, 4096), (1, 64), (200, 130),
                                 (16, 51200), (51200, 51200)])
def test_wide_splits_cover_every_tile(S, C):
    """The column ranges of hamw_kernel: none empty, each whole tiles, and
    about one wave of long blocks at config 7's streaming shapes (2048 x
    4096 and 4096^2: no split), a split where the rows are too few to
    fill the card."""
    for V in (3, 12, 28):
        rows = wide_shape(V)[0]
        cs = wide_splits(S, C, 132, rows)
        n_ct = -(-C // HAM_TC)
        tps = -(-n_ct // cs)
        assert 1 <= cs <= n_ct and (cs - 1) * tps < n_ct
        if (S, C) in ((2048, 4096), (4096, 4096)):
            assert cs == 1
        if -(-S // rows) * 4 <= 132 and n_ct >= 8:
            assert cs > 1


def test_bit_tiles_are_the_operand_layout():
    """``bit_tiles``: 16-byte chunk c of row q of tile t at (q // 8) x 3584
    + c x 128 + (q % 8) x 16 (csrc/stream.cu core_off, the layout the
    kernel's bulk copy puts in shared memory as wgmma's A), zero past C."""
    rng = np.random.default_rng(4)
    C = 150
    bits = torch.from_numpy((rng.random((C, BIT_ROW)) < 0.3).astype(np.int8))
    tiles = bit_tiles(bits).numpy()
    n_ct = -(-C // HAM_TC)
    assert tiles.shape == (n_ct, HAM_TC * BIT_ROW)
    for t in range(n_ct):
        for q in range(HAM_TC):
            row = t * HAM_TC + q
            for c in range(BIT_ROW // 16):
                off = (q // 8) * 3584 + c * 128 + (q % 8) * 16
                want = (bits[row, 16 * c:16 * c + 16].numpy() if row < C
                        else np.zeros(16, np.int8))
                np.testing.assert_array_equal(tiles[t, off:off + 16], want)
