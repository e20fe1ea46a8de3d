"""Padded per-scene k-nearest neighbours, counterpart of
``instancerefer_tpu/ops/knn.py``: a masked squared-distance matrix plus
``topk``.  A query's own scene is its only support set (supports are [B, M]
per scene); missing slots repeat the nearest valid support (slot 0), which
is exact under the downstream max aggregation."""

from __future__ import annotations

import torch


def knn_padded(query_xyz, support_xyz, support_mask, k: int):
    """query_xyz [B, Q, 3], support_xyz [B, M, 3], support_mask [B, M] bool.

    Returns idx [B, Q, k] int64 (ascending distance) and valid [B, Q, k]
    bool, False only where the scene has no valid support (idx is then 0).
    """
    d2 = ((query_xyz[:, :, None, :] - support_xyz[:, None, :, :]) ** 2).sum(-1)
    big = torch.finfo(d2.dtype).max
    d2 = torch.where(support_mask[:, None, :], d2, big)
    top, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    idx = torch.where(top < big, idx, idx[..., :1])
    valid = support_mask.any(-1)[:, None, None].expand(idx.shape)
    return torch.where(valid, idx, 0), valid
