"""Plain PyTorch sparse ops over padded rows.

Counterparts of ``instancerefer_tpu/ops/sparse.py``.  ``gather_conv`` here is
the plain twin of the CUDA kernel in ``ops/gather_conv.py``: the wrapper runs
it for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel
against it.
"""

from __future__ import annotations

from typing import Optional

import torch


def gather_conv(
    feats: torch.Tensor,
    nbr: torch.Tensor,
    weight: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """out[v] = sum_k feats[nbr[v, k]] @ weight[k], then the optional
    per-channel ``acc * scale + bias`` and ReLU, stored in ``feats.dtype``.

    Args:
      feats:  [V_in, Cin] bf16 or f32.
      nbr:    [V_out, K] int32 rows of ``feats``, -1 = empty neighbour.
      weight: [K, Cin, Cout] in ``feats.dtype``.
      scale/bias: optional [Cout] f32 (the folded eval BatchNorm).
    Products and the sum over k and Cin are f32, as in the kernel.
    """
    acc = feats.new_zeros(nbr.shape[0], weight.shape[2], dtype=torch.float32)
    table = torch.cat([feats, feats.new_zeros(1, feats.shape[1])]).float()
    safe = torch.where(nbr >= 0, nbr, feats.shape[0]).long()
    w = weight.float()
    for k in range(nbr.shape[1]):
        acc = acc + table[safe[:, k]] @ w[k]
    if scale is not None:
        acc = acc * scale + bias
    if relu:
        acc = torch.relu(acc)
    return acc.to(feats.dtype)


def masked_global_max_pool(
    feats: torch.Tensor, owner: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-owner max over rows (owner -1 = padding); owners with no rows
    pool to 0."""
    c = feats.shape[1]
    seg = torch.where(owner >= 0, owner, num_segments).long()
    out = feats.new_full((num_segments + 1, c), float("-inf"))
    out = out.scatter_reduce(0, seg[:, None].expand(-1, c), feats, "amax")
    count = torch.bincount(seg, minlength=num_segments + 1)[:num_segments]
    return torch.where(count[:, None] > 0, out[:num_segments], 0.0)
