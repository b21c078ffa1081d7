"""Faults planted underneath the timed path, for the readings that the
limits are set from and for the tests that see ``correct`` come out false.

Each fault wraps one function that ``registration/pipeline.py`` calls and
alters what it hands back; ``planted(name)`` puts it in place for the
``with`` block.  A one-chip cell has no exchange between chips to leave
out, so these are the faults that the cells can have:

* ``unchanged_state``: the engine hands back the pose it started from;
* ``half_the_points``: half of each cloud's points left out before the
  voxel filter;
* ``altered_match``: one final match given a target another row holds;
* ``altered_keypoint``: one keypoint moved 50 m where it is refined;
* ``half_unmatched``: half of the final matched rows left unmatched;
* ``wrong_assignment``: the final matching one-to-one but wrong (each
  matched row given the next matched row's target);
* ``nms_random``: the keypoint stage's suppression replaced by a random
  choice of as many pruning survivors (a broken K4).
"""
from __future__ import annotations

import contextlib

import torch


def unchanged_state(pipeline):
    orig = pipeline.ghicp_register_chunked

    def engine(*a, **k):
        r = orig(*a, **k)
        return r._replace(transform=torch.eye(4, dtype=r.transform.dtype,
                                              device=r.transform.device))
    return "ghicp_register_chunked", engine


def half_the_points(pipeline):
    orig = pipeline.voxel_downsample

    def voxel(cloud, size, *a, **k):
        keep = (torch.arange(cloud.mask.shape[0], device=cloud.mask.device)
                < cloud.mask.sum() // 2)
        return orig(type(cloud)(xyz=cloud.xyz, mask=cloud.mask & keep), size,
                    *a, **k)
    return "voxel_downsample", voxel


def _matches_fault(pipeline, alter):
    orig = pipeline.ghicp_register_chunked

    def engine(*a, **k):
        r = orig(*a, **k)
        m = r.matches.clone()
        rows = torch.nonzero(m >= 0).flatten()
        alter(m, rows)
        return r._replace(matches=m)
    return "ghicp_register_chunked", engine


def altered_match(pipeline):
    def alter(m, rows):
        m[rows[1]] = m[rows[0]]
    return _matches_fault(pipeline, alter)


def half_unmatched(pipeline):
    def alter(m, rows):
        m[rows[::2]] = -1
    return _matches_fault(pipeline, alter)


def wrong_assignment(pipeline):
    def alter(m, rows):
        m[rows] = torch.roll(m[rows], 1)
    return _matches_fault(pipeline, alter)


def altered_keypoint(pipeline):
    orig = pipeline.refine_positions

    def refine(kp, *a, **k):
        out = orig(kp, *a, **k).clone()
        out[0, 2] += 50.0
        return out
    return "refine_positions", refine


def nms_random(pipeline):
    orig = pipeline.detect_keypoints

    def detect(cloud, config, feats=None):
        r = orig(cloud, config, feats)
        cand = torch.nonzero(r.candidates).flatten()
        g = torch.Generator(device="cpu").manual_seed(7)
        pick = cand[torch.randperm(len(cand), generator=g)[
            :int(r.mask.sum())].to(cand.device)]
        mask = torch.zeros_like(r.mask)
        mask[pick] = True
        return r._replace(mask=mask)
    return "detect_keypoints", detect


FAULTS = {f.__name__: f for f in (
    unchanged_state, half_the_points, altered_match, altered_keypoint,
    half_unmatched, wrong_assignment, nms_random)}

# the compared number that each fault is there to break
BREAKS = {"unchanged_state": "rot_deg", "half_the_points": "down_gap",
          "altered_match": "match_broken", "altered_keypoint": "kp_off",
          "half_unmatched": "match_true", "wrong_assignment": "match_true",
          "nms_random": "kp_close"}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place of the function it wraps, for the
    block."""
    from ghicp_tpu_torch.registration import pipeline
    attr, fn = FAULTS[name](pipeline)
    orig = getattr(pipeline, attr)
    setattr(pipeline, attr, fn)
    try:
        yield
    finally:
        setattr(pipeline, attr, orig)
