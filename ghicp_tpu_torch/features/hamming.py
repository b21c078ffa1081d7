"""Hamming feature-distance matrix between packed binary descriptors.

With a, b in {0, 1}^n, ham(a, b) = |a| + |b| - 2 a.b, so the whole [S, T]
matrix is one product of the unpacked bit rows plus rank-one corrections.
The product runs in float32 (TF32 stays off): every partial sum is an
integer below 2^24, so the result is exact on the card and on the host.
This is a plain matrix product outside any TPU kernel of the JAX package,
so it goes to ``torch.matmul``.

``min_hamming_fd`` is the GH-ICP feature distance: the minimum over the
source's flipped-LCS variants against the target's first variant.
"""
from __future__ import annotations

import torch

from ghicp_tpu_torch.features.bsc import unpack_bits


def hamming_matrix(a_packed: torch.Tensor, b_packed: torch.Tensor,
                   n_bits: int) -> torch.Tensor:
    """[S, T] float32 Hamming distances from [S, W], [T, W] packed words."""
    a = unpack_bits(a_packed, n_bits)
    b = unpack_bits(b_packed, n_bits)
    return (a.sum(dim=1)[:, None] + b.sum(dim=1)[None, :]
            - 2.0 * torch.matmul(a, b.T))


def min_hamming_fd(src_packed: torch.Tensor, tgt_packed: torch.Tensor,
                   n_bits: int) -> torch.Tensor:
    """FD[i, j] = min over source variants v of ham(src[v, i], tgt[0, j]).
    src_packed [V, S, W]; tgt_packed [V', T, W].  Returns [S, T] float32."""
    fd = None
    for v in range(src_packed.shape[0]):
        h = hamming_matrix(src_packed[v], tgt_packed[0], n_bits)
        fd = h if fd is None else torch.minimum(fd, h)
    return fd
