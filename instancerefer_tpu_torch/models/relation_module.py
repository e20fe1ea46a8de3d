"""Relation module, counterpart of
``instancerefer_tpu/models/relation_module.py``: kNN (k = 8) from each
candidate to the instances of its scene, an EdgeConv with learned edge
weights and max aggregation, and the cosine against the relation language
embedding.  ``relation_scores`` is [B, C], aligned with ``cand_mask``.  In
train mode the language BatchNorm counts the rows of ``sample_valid`` and
the dropouts are live."""

from __future__ import annotations

import torch
from torch import nn

from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
from instancerefer_tpu_torch.ops.knn import knn_padded


def cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    """dot / max(||a|| * ||b||, eps), written out: F.cosine_similarity
    clamps each norm separately."""
    na = torch.linalg.vector_norm(a, dim=dim)
    nb = torch.linalg.vector_norm(b, dim=dim)
    return (a * b).sum(dim) / (na * nb).clamp(min=eps)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, F], idx [B, ...] -> [B, ..., F] rows of each sample."""
    flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).view(*idx.shape, x.shape[-1])


class DynamicEdgeConv(nn.Module):
    def __init__(self, f_in: int, f_out: int, k: int, num_classes: int):
        super().__init__()
        self.k = k
        self.num_classes = num_classes
        self.weight = nn.Sequential(
            nn.Linear(3 + 2 * num_classes, 64), nn.ReLU(), nn.Linear(64, f_in)
        )
        self.mlp = nn.Sequential(nn.Linear(3 * f_in, f_out), nn.ReLU(), nn.Linear(f_out, f_out))

    def forward(self, node_feats, node_xyz, node_mask, query_slot, query_mask):
        """node_*: [B, M, ...]; query_slot [B, C] -> [B, C, f_out], zeros
        for invalid queries."""
        m = node_feats.shape[1]
        safe = query_slot.clamp(0, m - 1)
        q_xyz = _take(node_xyz, safe)  # [B, C, 3]
        q_feat = _take(node_feats, safe)
        idx, nbr_valid = knn_padded(q_xyz, node_xyz, node_mask, self.k)  # [B, C, k]
        x_j = _take(node_feats, idx)  # [B, C, k, F]
        x_i = q_feat[:, :, None, :].expand_as(x_j)
        pos_delta = _take(node_xyz, idx) - q_xyz[:, :, None, :]
        nc = self.num_classes
        w = self.weight(torch.cat([pos_delta, x_i[..., -nc:], x_j[..., -nc:]], -1))
        msg = self.mlp(torch.cat([x_i, w, x_j], -1))
        msg = torch.where(nbr_valid[..., None], msg, torch.finfo(msg.dtype).min)
        agg = msg.amax(2)
        has = nbr_valid.any(-1) & query_mask
        return torch.where(has[..., None], agg, 0.0)


class RelationModule(nn.Module):
    def __init__(self, input_feature_dim: int, num_classes: int, k: int = 8, v_dim: int = 128,
                 h_dim: int = 128, l_dim: int = 256, dropout_rate: float = 0.15):
        super().__init__()
        self.num_classes = num_classes
        self.gcn = DynamicEdgeConv(input_feature_dim + num_classes, v_dim, k, num_classes)
        self.vis_emb_fc = nn.Sequential(
            nn.Linear(v_dim, h_dim), nn.LayerNorm(h_dim), nn.ReLU(), nn.Dropout(dropout_rate),
            nn.Linear(h_dim, h_dim),
        )
        self.lang_emb_fc = nn.Sequential(
            nn.Linear(l_dim, h_dim), MaskedBatchNorm(h_dim), nn.ReLU(),
            nn.Dropout(dropout_rate), nn.Linear(h_dim, h_dim),
        )

    def forward(self, data_dict: dict) -> dict:
        out = dict(data_dict)
        inst_mask = data_dict["instance_mask"]
        classes = torch.arange(self.num_classes, device=inst_mask.device)
        onehot = (data_dict["instance_class"].clamp(0, self.num_classes - 1)[..., None]
                  == classes).float() * inst_mask[..., None]
        node_feats = torch.cat([data_dict["instance_node_feat"], onehot], -1)  # [B, M, 25]
        feats = self.gcn(
            node_feats, data_dict["instance_obbs"][..., 0:3], inst_mask,
            data_dict["cand_slot"], data_dict["cand_mask"],
        )
        vis = self.vis_emb_fc(feats)
        fc = self.lang_emb_fc
        lang = torch.relu(fc[1](fc[0](data_dict["lang_rel_feats"]), data_dict.get("sample_valid")))
        lang = fc[4](fc[3](lang))
        out["relation_scores"] = cosine_similarity(vis, lang[:, None, :], dim=-1)
        return out
