"""Attribute module, counterpart of
``instancerefer_tpu/models/attribute_module.py``: the sparse-conv encoder
over every candidate at once, a global max pool per candidate, and the dot
product of the normalized visual and language embeddings.  Candidates arrive
padded with ``cand_mask``; ``score_mask`` marks the rows the reference
scores (samples with >= 2 candidates).  The language BatchNorm's train
statistics count the rows of ``sample_valid``."""

from __future__ import annotations

import torch
from torch import nn

from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm, SparseConvEncoder
from instancerefer_tpu_torch.ops.sparse import masked_global_max_pool


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), written out as the JAX package does."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


class AttributeModule(nn.Module):
    def __init__(self, input_feature_dim: int, max_candidates: int, v_dim: int = 128,
                 h_dim: int = 256, l_dim: int = 256):
        super().__init__()
        self.max_candidates = max_candidates
        self.v_dim = v_dim
        self.net = SparseConvEncoder(input_feature_dim)
        self.vis_emb_fc = nn.Sequential(
            nn.Linear(v_dim, h_dim), nn.LayerNorm(h_dim), nn.ReLU(), nn.Linear(h_dim, h_dim)
        )
        self.lang_emb_fc = nn.Sequential(
            nn.Linear(l_dim, h_dim), MaskedBatchNorm(h_dim), nn.ReLU(), nn.Linear(h_dim, h_dim)
        )

    def forward(self, data_dict: dict) -> dict:
        out = dict(data_dict)
        pyramid = data_dict["inst_pyramid"]
        cand_mask = data_dict["cand_mask"]
        b, c = cand_mask.shape[0], self.max_candidates

        fc = self.lang_emb_fc
        lang = torch.relu(fc[1](fc[0](data_dict["lang_attr_feats"]), data_dict.get("sample_valid")))
        lang = l2_normalize(fc[3](lang), dim=1)
        feats = self.net(data_dict["inst_feats"], pyramid)
        pooled = masked_global_max_pool(feats, pyramid[-1].owner, b * c).view(b, c, self.v_dim)
        out["obj_feats"] = pooled
        vis = l2_normalize(self.vis_emb_fc(pooled), dim=-1)

        num_filtered = cand_mask.sum(1)
        out["attribute_scores"] = torch.einsum("bch,bh->bc", vis, lang)
        out["score_mask"] = cand_mask & (num_filtered >= 2)[:, None]
        out["num_filtered_objs"] = num_filtered
        return out
