"""Hamming feature-distance matrices between packed binary descriptors.

Two paths give the same integers:

* :func:`hamming_matrix_popcount`: XOR of the packed words and a popcount,
  ``block`` source rows at a time;
* :func:`hamming_matrix_mxu`: with a, b in {0, 1}^n, ham(a, b) = |a| + |b|
  - 2 a.b, so the whole [S, T] matrix is one product of the unpacked bit
  rows plus rank-one corrections.  The product runs in float32 (TF32
  stays off): every partial sum is an integer below 2^24, so the result
  is exact on the card and on the host.  This is a plain matrix product
  outside any TPU kernel of the JAX package, so it goes to
  ``torch.matmul``.

``min_hamming_fd`` is the GH-ICP feature distance: the minimum over the
source's flipped-LCS variants against the target's first variant.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.features.bsc import unpack_bits
from ghicp_tpu_torch.ops.stream_kernel import popcount32


def hamming_matrix_popcount(a_packed: torch.Tensor, b_packed: torch.Tensor,
                            block: int = 1024) -> torch.Tensor:
    """[S, T] int32 Hamming distances from [S, W], [T, W] packed words
    (32 bits a word), ``block`` source rows a step."""
    b = b_packed.to(torch.int64)
    rows = [popcount32(a[:, None, :] ^ b[None, :, :]).sum(dim=-1)
            for a in torch.split(a_packed.to(torch.int64), block)]
    return torch.cat(rows).to(torch.int32)


def hamming_matrix_mxu(a_packed: torch.Tensor, b_packed: torch.Tensor,
                       n_bits: int) -> torch.Tensor:
    """[S, T] float32 Hamming distances from [S, W], [T, W] packed words
    as one float32 product of the unpacked bits."""
    a = unpack_bits(a_packed, n_bits)
    b = unpack_bits(b_packed, n_bits)
    return (a.sum(dim=1)[:, None] + b.sum(dim=1)[None, :]
            - 2.0 * torch.matmul(a, b.T))


def min_hamming_fd(src_packed: torch.Tensor, tgt_packed: torch.Tensor,
                   n_bits: int, use_mxu: bool = True) -> torch.Tensor:
    """FD[i, j] = min over source variants v of ham(src[v, i], tgt[0, j]).
    src_packed [V, S, W]; tgt_packed [V', T, W].  Returns [S, T] float32,
    the same values by either path (``use_mxu``: the product, else the
    popcount)."""
    fd = None
    for v in range(src_packed.shape[0]):
        if use_mxu:
            h = hamming_matrix_mxu(src_packed[v], tgt_packed[0], n_bits)
        else:
            h = hamming_matrix_popcount(src_packed[v], tgt_packed[0]).to(
                torch.float32)
        fd = h if fd is None else torch.minimum(fd, h)
    return fd
