"""Row-wise top-2 of (b - p) (kernel K6), Triton, with its plain version.

Replaces ``ghicp_tpu/ops/top2.py::top2_rows_pallas`` (Pallas
``_top2_kernel``), the hot reduction of every Jacobi bidding round
(:func:`ghicp_tpu_torch.matching.auction._bidding_round`).  For b
[P, R, C] (bf16 or float32) and prices p [P, C] it returns, per row of
``b.float() - p``:

  v1  the row maximum,
  j1  its column, the LOWEST column among equal maxima,
  v2  the maximum over every column but j1, floored at -3e38 (so a
      duplicated maximum gives v2 = v1),

exactly as the JAX package's ``top2_rows_ref`` with a leading pair axis.

Bound on this card: memory — one read of b (2 bytes an entry in bf16),
0.241 ms at [6, 8192, 8192] at 3.35 TB/s; the arithmetic (a subtract, two
maxima and a compare an entry) is far below the float32 rate.  Design:
the grid runs over (pair, row block); each program walks its rows' column
blocks in order and merges each block's (max, lowest argmax, second) into
its running (v1, j1, v2) as the TPU kernel does: j1 moves only on a
strictly larger block maximum, and v2 = max(min(v1, m1), v2, m2).  The
block argmax is the minimum column among the block's maxima, so the tie
rule does not rest on ``tl.argmax``.  A simple first version: no
software pipelining beyond Triton's own.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.ops import as_rows, count_launch, require_device

NEG = -3.0e38
BLOCK_R = 16
BLOCK_C = 512

_KERNEL = None


def top2_rows_plain(b: torch.Tensor, p: torch.Tensor):
    """Plain PyTorch version of K6: argmax, gather, masked re-max."""
    v = b.float() - p[:, None, :]
    j1 = torch.argmax(v, dim=-1)
    v1 = v.gather(-1, j1[..., None])[..., 0]
    cols = torch.arange(b.shape[-1], device=b.device)
    v2 = torch.where(cols == j1[..., None], NEG, v).amax(dim=-1)
    return v1, j1.to(torch.int32), v2


def _kernel():
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    from ghicp_tpu_torch.ops._build import triton_cache
    triton_cache()
    import triton
    import triton.language as tl

    @triton.jit
    def top2_kernel(b_ptr, p_ptr, v1_ptr, j1_ptr, v2_ptr, R, C,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pair = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
        rmask = rows < R
        base = b_ptr + pair.to(tl.int64) * R * C
        v1 = tl.full([BLOCK_R], float("-inf"), tl.float32)
        j1 = tl.zeros([BLOCK_R], tl.int32)
        v2 = tl.full([BLOCK_R], -3.0e38, tl.float32)
        for c0 in range(0, C, BLOCK_C):
            cols = c0 + tl.arange(0, BLOCK_C)
            cmask = cols < C
            p = tl.load(p_ptr + pair * C + cols, mask=cmask, other=0.0)
            off = rows[:, None].to(tl.int64) * C + cols[None, :]
            bv = tl.load(base + off, mask=rmask[:, None] & cmask[None, :],
                         other=0.0).to(tl.float32)
            v = tl.where(cmask[None, :], bv - p[None, :], float("-inf"))
            m1 = tl.max(v, axis=1)
            a1 = tl.min(tl.where(v == m1[:, None], cols[None, :], C), axis=1)
            m2 = tl.max(tl.where(cols[None, :] == a1[:, None],
                                 float("-inf"), v), axis=1)
            v2 = tl.maximum(tl.minimum(v1, m1), tl.maximum(v2, m2))
            j1 = tl.where(m1 > v1, a1, j1)
            v1 = tl.maximum(v1, m1)
        out = pair * R + rows
        tl.store(v1_ptr + out, v1, mask=rmask)
        tl.store(j1_ptr + out, j1, mask=rmask)
        tl.store(v2_ptr + out, v2, mask=rmask)

    _KERNEL = top2_kernel
    return _KERNEL


def top2_rows_cuda(b: torch.Tensor, p: torch.Tensor):
    """Launch K6 on the card."""
    P, R, C = b.shape
    if b.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"top2_rows kernel takes bf16 or float32 b, got "
                         f"{b.dtype}")
    dev = b.device
    b = b.contiguous()
    p = as_rows(p, P, C, torch.float32, dev, "p")
    v1 = torch.empty((P, R), dtype=torch.float32, device=dev)
    j1 = torch.empty((P, R), dtype=torch.int32, device=dev)
    v2 = torch.empty((P, R), dtype=torch.float32, device=dev)
    _kernel()[(P, -(-R // BLOCK_R))](b, p, v1, j1, v2, R, C,
                                     BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C,
                                     num_warps=4)
    count_launch("top2_rows")
    return v1, j1, v2


def top2_rows(b: torch.Tensor, p: torch.Tensor):
    """(v1, j1, v2) [P, R] of ``b.float() - p`` for b [P, R, C] and p
    [P, C] float32.  CUDA tensors run the Triton kernel, CPU tensors the
    plain version."""
    if b.ndim != 3 or tuple(p.shape) != (b.shape[0], b.shape[2]):
        raise ValueError(f"top2_rows: b [P, R, C] and p [P, C], got "
                         f"{tuple(b.shape)} and {tuple(p.shape)}")
    if require_device(b, "top2_rows") == "cuda":
        return top2_rows_cuda(b, p)
    return top2_rows_plain(b, p)
