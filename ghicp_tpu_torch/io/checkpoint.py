"""Feature and registration persistence (the reference's only persistence
surfaces, SURVEY.md §5).

* :func:`save_features` / :func:`load_features`: a BSC encoding as one
  ``.npz`` of its packed 32-bit words (stored as uint32, the JAX
  package's layout and keys, so a file written by either package loads in
  the other) and the sampling pattern's seed and grid side
  (``StereoBinaryFeature::writeFeatures/readFeatures``,
  src/stereo_binary_feature.cpp:107-147): a scan is encoded once and
  reused across the pairs of a station graph.
* :func:`save_registration` / :func:`load_registration`: the final
  transform, metrics and the config snapshot as JSON; the transform
  reloaded into ``register_pair(initial_transform=...)`` refines a pose
  instead of starting from scratch.

Pure host files; :func:`load_features` puts the words on ``device``.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.device import DeviceLike, resolve_device
from ghicp_tpu_torch.features.bsc import BSCFeatures
from ghicp_tpu_torch.interop import config_from_dict, config_to_dict


def save_features(path: str, feats: BSCFeatures, seed: int,
                  grid_side: int) -> None:
    np.savez_compressed(
        path, packed=feats.packed.cpu().numpy().astype(np.uint32),
        mask=feats.mask.cpu().numpy(), n_bits=feats.n_bits, seed=seed,
        grid_side=grid_side)


def load_features(path: str, device: DeviceLike = None
                  ) -> Tuple[BSCFeatures, int, int]:
    """(features on ``device``, seed, grid side); the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    with np.load(path) as z:
        feats = BSCFeatures(
            packed=torch.as_tensor(z["packed"].astype(np.int64), device=dev),
            mask=torch.as_tensor(z["mask"], device=dev),
            n_bits=int(z["n_bits"]))
        return feats, int(z["seed"]), int(z["grid_side"])


def save_registration(path: str, transform: np.ndarray,
                      config: GHICPConfig,
                      metrics: Optional[dict] = None) -> None:
    blob = {"transform": np.asarray(transform).tolist(),
            "config": config_to_dict(config), "metrics": metrics or {}}
    with open(path, "w") as f:
        json.dump(blob, f, indent=1)


def load_registration(path: str) -> Tuple[np.ndarray, GHICPConfig, dict]:
    """(transform [4, 4] float32, config, the whole JSON blob)."""
    with open(path) as f:
        blob = json.load(f)
    return (np.asarray(blob["transform"], np.float32),
            config_from_dict(blob["config"]), blob)
