"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors only.  Each launch adds one to the kernel's
count in :data:`LAUNCHES`, so a run can show which kernels its path went
through; the FPFH/RoPS (multiplicative-blend) variants of K1, K3 and K5
count under their own ``*_mult`` names, the float32 variants of K1-K3
(the ``auction_bf16=False`` lane) and of K7 / K8 under ``*_f32``, K5's
feature-"none" variant under ``stream_sweep_none`` and its column-side
variants under ``*_col``, and the Hamming lane past four variants
(``hamw_kernel``) once more under ``stream_sweep_wide`` (``_col``); each
K5 launch also counts under
``<name>@<rows>``, the rows it swept, so that full-height and compacted
sweeps can be told apart, each K4 launch under ``nms_exact@<slots>`` and
each K1, K2 and K3 launch under ``<name>@<rows>``, its keypoint slots.
The ring lane's ``ring_sweep`` (n K5 launches over rotated target blocks)
counts once a sweep under its own name, beside its K5 launches.  A K5
launch replayed from a CUDA graph counts as one launched by its wrapper.
The streaming solve's bidding rounds count here too, none under a
``stream_sweep`` name: ``stream_round_eager`` the rounds run eagerly,
``stream_round_graph`` the active rounds replayed from a graph,
``stream_round_idle`` the guarded rounds (replayed, or run eagerly on the
CPU) that did nothing, and ``stream_graph_capture`` the graphs captured.
"""
from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {"fused_benefit": 0, "auction_phase_gs": 0,
                            "auction_warm_fused": 0, "nms_exact": 0,
                            "stream_sweep": 0, "top2_rows": 0,
                            "ring_sweep": 0,
                            "fused_benefit_mult": 0,
                            "auction_warm_fused_mult": 0,
                            "stream_sweep_mult": 0, "stream_sweep_col": 0,
                            "stream_sweep_mult_col": 0,
                            "stream_sweep_none": 0,
                            "stream_sweep_none_col": 0,
                            "stream_sweep_wide": 0,
                            "stream_sweep_wide_col": 0,
                            "fused_benefit_f32": 0,
                            "fused_benefit_mult_f32": 0,
                            "auction_phase_gs_f32": 0,
                            "auction_warm_fused_f32": 0,
                            "auction_warm_fused_mult_f32": 0,
                            "auction_rounds": 0, "auction_rounds_f32": 0,
                            "auction_phase": 0, "auction_phase_f32": 0,
                            "stream_round_eager": 0,
                            "stream_round_graph": 0,
                            "stream_round_idle": 0,
                            "stream_graph_capture": 0}


def count_launch(name: str, n: int = 1) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def as_rows(x, n: int, width: int, dtype, device, what: str):
    """``x`` as a contiguous [n] (``width`` 0) or [n, width] tensor of
    ``dtype`` on ``device``, checked before a kernel gets its pointer."""
    shape = (n,) if width == 0 else (n, width)
    if (torch.is_tensor(x) and x.dtype == dtype and x.device == device
            and x.shape == shape and x.is_contiguous()):
        return x
    x = torch.as_tensor(x)
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    return x.to(device=device, dtype=dtype).contiguous()


def require_device(t, what: str) -> str:
    """'cuda' or 'cpu' for a kernel wrapper's input; any other device
    raises (there is no plain fallback for a CUDA tensor)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type
