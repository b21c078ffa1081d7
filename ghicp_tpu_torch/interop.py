"""Carry configurations and engine state across from the JAX package.

Takes plain dicts and numpy arrays only (never JAX objects), so the port
still imports nothing of JAX: a caller that holds a JAX engine state
converts it with ``numpy.asarray`` field by field and starts the port's
engine from the identical state.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import numpy as np
import torch

from ghicp_tpu_torch.core.config import (CorrespondenceType, FeatureType,
                                         GHICPConfig)
from ghicp_tpu_torch.features.bsc import pack_bits
from ghicp_tpu_torch.matching.stream_auction import StreamCarry, carry_init
from ghicp_tpu_torch.ops.stream_kernel import (DescFeatures, StreamFeatures,
                                               stream_features, to_words)
from ghicp_tpu_torch.registration.ghicp import IterationMetrics, _State

_ENUMS = {"feature": FeatureType, "correspondence": CorrespondenceType}


def config_from_dict(d: Mapping) -> GHICPConfig:
    """A config from field values; enum fields may be members of any
    enum with the same values, or the values themselves."""
    kw = {}
    for f in dataclasses.fields(GHICPConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _ENUMS:
            v = _ENUMS[f.name](v.value if isinstance(v, enum.Enum) else v)
        kw[f.name] = v
    return GHICPConfig(**kw)


def config_to_dict(config: GHICPConfig) -> dict:
    """Field values with enums as their string values."""
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        out[f.name] = v.value if isinstance(v, enum.Enum) else v
    return out


def stream_features_from_numpy(fs, ft, na, nb, n_bits: int = 441,
                               device="cpu") -> StreamFeatures:
    """The port's packed factors from the JAX ``StreamFeatures`` fields as
    numpy arrays: unpacked {0, 1} bits ``fs`` [V, S, F] and ``ft`` [C, F]
    (F >= n_bits, zero-padded), popcounts ``na`` [V, S] and ``nb`` [C]."""
    n_words = -(-n_bits // 32)
    bits = lambda x: torch.tensor(
        np.asarray(x)[..., :32 * n_words].astype(np.int64), device=device)
    return stream_features(
        to_words(pack_bits(bits(fs))), to_words(pack_bits(bits(ft))),
        torch.tensor(np.asarray(na, np.float32), device=device),
        torch.tensor(np.asarray(nb, np.float32), device=device))


def desc_features_from_numpy(fs, ft, dim: int, device="cpu") -> DescFeatures:
    """The port's similarity-lane factors from the JAX descriptor
    ``StreamFeatures`` fields as numpy arrays: standardized bf16 rows
    ``fs`` [1, S, F] (or [S, F]) and ``ft`` [C, F], ``dim`` the descriptor
    length D.  The values pass through float32, which holds every bf16
    value exactly."""
    rows = lambda x: torch.tensor(np.asarray(x, np.float32),
                                  device=device).to(torch.bfloat16)
    fs = rows(fs)
    return DescFeatures(fs=fs.reshape(-1, fs.shape[-1]).contiguous(),
                        ft=rows(ft).contiguous(), dim=int(dim))


def state_from_numpy(arrays: Mapping, device, max_iterations: int = 100
                     ) -> _State:
    """The port's engine state from the JAX ``_State`` fields as numpy
    arrays (``metrics`` optional: a mapping of its arrays, the port's own
    ``open_rows``, ``compact_sweeps`` and ``fast`` zero where absent;
    ``scarry`` optional: a mapping of the eight ``StreamCarry`` fields)."""
    dev = torch.device(device)
    f32 = lambda k: torch.tensor(np.asarray(arrays[k], np.float32),
                                 device=dev)
    i64 = lambda k: torch.tensor(np.asarray(arrays[k], np.int64), device=dev)
    met = dict(arrays.get("metrics") or {})
    n_it = len(np.asarray(met["cor"])) if "cor" in met else max_iterations
    ints = ("cor", "rounds", "open_rows", "compact_sweeps", "fast")
    metrics = IterationMetrics(**{
        k: torch.tensor(np.asarray(met.get(k, np.zeros(n_it)),
                                   np.int64 if k in ints else np.float32),
                        device=dev)
        for k in IterationMetrics._fields})
    sc = arrays.get("scarry")
    if sc is None:
        scarry = carry_init(np.asarray(arrays["acol"]).shape[0], dev)
    else:
        scarry = StreamCarry(ok=bool(np.asarray(sc["ok"])), **{
            k: torch.tensor(np.asarray(sc[k], np.float32), device=dev)
            for k in StreamCarry._fields if k != "ok"})
    return _State(
        kps=f32("kps"), rt=f32("rt"), it=int(np.asarray(arrays["it"])),
        converged=bool(np.asarray(arrays["converged"])), rms=f32("rms"),
        fdm=f32("fdm"), fdstd=f32("fdstd"), para1=f32("para1"),
        para2=f32("para2"), metrics=metrics, matches=i64("matches"),
        rmse_after=f32("rmse_after"), prices=f32("prices"),
        acol=i64("acol"), price_unc=f32("price_unc"),
        pen_prev=f32("pen_prev"),
        it_shift=float(np.asarray(arrays["it_shift"])), scarry=scarry)
