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


def state_from_numpy(arrays: Mapping, device, max_iterations: int = 100
                     ) -> _State:
    """The port's engine state from the JAX ``_State`` fields as numpy
    arrays (``metrics`` optional: a mapping of its seven arrays)."""
    dev = torch.device(device)
    f32 = lambda k: torch.tensor(np.asarray(arrays[k], np.float32),
                                 device=dev)
    i64 = lambda k: torch.tensor(np.asarray(arrays[k], np.int64), device=dev)
    met = arrays.get("metrics")
    if met is None:
        zf = torch.zeros((max_iterations,), dtype=torch.float32, device=dev)
        zi = torch.zeros((max_iterations,), dtype=torch.int64, device=dev)
        metrics = IterationMetrics(zf.clone(), zf.clone(), zf.clone(),
                                   zi.clone(), zf.clone(), zf.clone(),
                                   zi.clone())
    else:
        conv = {"cor": np.int64, "rounds": np.int64}
        metrics = IterationMetrics(**{
            k: torch.tensor(np.asarray(met[k], conv.get(k, np.float32)),
                            device=dev)
            for k in IterationMetrics._fields})
    return _State(
        kps=f32("kps"), rt=f32("rt"), it=int(np.asarray(arrays["it"])),
        converged=bool(np.asarray(arrays["converged"])), rms=f32("rms"),
        fdm=f32("fdm"), fdstd=f32("fdstd"), para1=f32("para1"),
        para2=f32("para2"), metrics=metrics, matches=i64("matches"),
        rmse_after=f32("rmse_after"), prices=f32("prices"),
        acol=i64("acol"), price_unc=f32("price_unc"),
        pen_prev=f32("pen_prev"),
        it_shift=float(np.asarray(arrays["it_shift"])))
