"""The plain reference's functions give the right answers on small
inputs, and it imports nothing of the program."""
import ast
import itertools

import numpy as np
import pytest

import gen
from bench_small import ROOT
from reference import check


def test_voxel_first_against_a_loop():
    rng = np.random.default_rng(0)
    p = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    got = check.voxel_first(p, 0.5)
    mn = p.min(axis=0)
    seen, want = set(), []
    for q in p:
        cell = tuple(np.floor((q - mn) * np.float32(2.0)).astype(int))
        if cell not in seen:
            seen.add(cell)
            want.append(q)
    assert np.array_equal(got, np.array(want))


def test_errors_of_a_known_pose():
    T = gen._pose(gen._yaw(20.0), np.float32([2.0, -1.5, 0.3]))
    U = gen._pose(gen._yaw(20.5), np.float32([2.0, -1.5, 0.4]))
    assert check.rotation_error_deg(T, T) == pytest.approx(0.0, abs=1e-3)
    assert check.rotation_error_deg(U, T) == pytest.approx(0.5, abs=1e-3)
    assert check.translation_error_m(U, T) == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("matches,n,want", [
    ([0, 1, 2, -1], 3, 0), ([0, 0, 2, -1], 3, 1), ([0, 3, 2], 3, 1),
    ([-1, -1], 5, 0), ([4, 4, 4], 5, 2)])
def test_broken_matches(matches, n, want):
    assert check.broken_matches(np.array(matches), n) == want


def small_pair():
    """A small generated pair, its reference, and keypoints on each cloud
    that the true pose carries onto each other (each target keypoint the
    target's downsampled point nearest to a moved source keypoint, those
    within half a voxel kept)."""
    src, tgt, T = gen.bench_pair(3, 6000, 8.0, 20.0, [1.0, -0.5, 0.2],
                                 0.006)
    ref = check.PairReference(src, tgt, T, 0.15)
    kp_s = ref.down[0][::50]
    moved = kp_s @ T[:3, :3].T + T[:3, 3]
    d, j = ref.trees[1].query(moved)
    keep = d < 0.075
    kp_s, kp_t = kp_s[keep], ref.down[1][j[keep]]
    out = {"transform": T, "matches": np.arange(len(kp_s)),
           "keypoints_source": kp_s, "keypoints_target": kp_t,
           "n_down": (len(ref.down[0]), len(ref.down[1]))}
    return ref, out


def test_judge_on_a_small_pair():
    ref, out = small_pair()
    kp_s = out["keypoints_source"]
    assert len(kp_s) > 20
    assert ref.judge(out, 0.5) == {"rot_deg": pytest.approx(0.0, abs=1e-3),
                                   "t_m": 0.0, "down_gap": 0, "kp_off": 0,
                                   "match_broken": 0, "kp_close": 0.0,
                                   "match_true": 1.0}
    far = dict(out, keypoints_source=kp_s + np.float32([0, 0, 50.0]),
               n_down=(len(ref.down[0]) - 7, len(ref.down[1])),
               matches=np.zeros(len(kp_s), np.int64))
    got = ref.judge(far, 0.5)
    assert got["kp_off"] == len(kp_s) and got["down_gap"] == 7
    assert got["match_broken"] == len(kp_s) - 1
    assert got["match_true"] == 0.0


@pytest.mark.parametrize("alter,want", [
    (lambda m: m, 1.0),
    (lambda m: np.where(np.arange(len(m)) % 2 == 0, -1, m), 0.5),
    (lambda m: np.roll(m, 1), 0.0),
    (lambda m: np.full_like(m, -1), 0.0)],
    ids=["true", "half_unmatched", "wrong_assignment", "none"])
def test_matching_against_the_true_pose(alter, want):
    ref, out = small_pair()
    got = ref.judge(dict(out, matches=alter(out["matches"])), 0.5)
    assert got["match_true"] == pytest.approx(want, abs=1.0 / len(
        out["matches"]))
    assert got["match_broken"] == 0


def test_keypoints_off_the_true_pose_match_nothing_true():
    ref, out = small_pair()
    shifted = out["keypoints_target"] + np.float32([0.4, 0.0, 0.0])
    got = ref.judge(dict(out, keypoints_target=shifted), 0.5)
    assert got["match_true"] == 0.0


def test_close_keypoints():
    a = np.float32([[0, 0, 0], [0.1, 0, 0], [5, 0, 0], [9, 0, 0]])
    b = np.float32([[0, 0, 0], [3, 0, 0]])
    assert check.close_share([a, b], 0.2) == pytest.approx(2 / 6)
    assert check.close_share([a, b], 0.05) == 0.0
    assert check.close_share([a[:1], b[:0]], 1.0) == 0.0


def test_limits_tighten_and_floors():
    lim = check.limits({"rot_deg": 0.5, "t_m": 0.1},
                       {"rot_deg": 0.06, "t_m": 0.4, "kp_close": 0.03,
                        "match_true": 0.5})
    assert lim == {"rot_deg": 0.06, "t_m": 0.1, "down_gap": 0, "kp_off": 0,
                   "match_broken": 0, "kp_close": 0.03, "match_true": 0.5}
    assert check.breaks("match_true", 0.49, 0.5)
    assert not check.breaks("match_true", 0.51, 0.5)
    assert check.breaks("kp_close", 0.04, 0.03)
    assert check.breaks("rot_deg", 0.07, 0.06)
    assert check.worse("match_true", 0.4, 0.6) == 0.4
    assert check.worse("t_m", 0.4, 0.6) == 0.6


def test_visits_send_every_pair_each_cycle():
    v = list(itertools.islice(gen.visits(4, 2**31 + 5), 40))
    for c in range(10):
        assert sorted(v[4 * c:4 * c + 4]) == [0, 1, 2, 3]
    assert v == list(itertools.islice(gen.visits(4, 2**31 + 5), 40))
    assert v != list(itertools.islice(gen.visits(4, 6), 40))


def imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    (ROOT / "bench_port" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(imported_roots(path)) & {"ghicp_tpu_torch", "ghicp_tpu",
                                            "jax", "jaxlib", "flax"}
