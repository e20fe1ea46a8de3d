"""Scene module, counterpart of ``instancerefer_tpu/models/scene_module.py``:
BEV encoder over the whole scene, crop and scatter to a dense 15 x 25 BEV,
two VALID 3 x 3 ``nn.Conv2d`` (NCHW, fed from the NHWC BEV through one
permute) down to 11 x 21 = 231 cells, language attention over the cells,
the 9-way region head and the scene <-> object cosine.  In train mode the
BatchNorms take ``sample_valid`` (as whole BEV planes on the two dense
ones) and the dropouts are live."""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from instancerefer_tpu_torch.models.basic_blocks import (
    BEVEncoder,
    MaskedBatchNorm,
    ToDenseBEVConvolution,
    sparse_crop_mask,
)
from instancerefer_tpu_torch.models.relation_module import cosine_similarity


class SceneModule(nn.Module):
    def __init__(self, input_feature_dim: int, v_dim: int = 128, h_dim: int = 128,
                 l_dim: int = 256, dropout_rate: float = 0.15,
                 loc_min: Tuple[int, int, int] = (0, 0, 0),
                 loc_max: Tuple[int, int, int] = (240, 400, 80)):
        super().__init__()
        self.h_dim = h_dim
        self.loc_min, self.loc_max = loc_min, loc_max
        stride = 16
        bev = ((loc_max[0] - loc_min[0]) // stride, (loc_max[1] - loc_min[1]) // stride)
        nz = (loc_max[2] - loc_min[2]) // stride
        self.net = BEVEncoder(input_feature_dim)
        self.to_bev = nn.Sequential(
            nn.Identity(), ToDenseBEVConvolution(v_dim, v_dim, bev, nz), MaskedBatchNorm(v_dim),
            nn.ReLU(),
        )
        self.vis_emb_fc = nn.Sequential(
            nn.Conv2d(v_dim, h_dim, 3), MaskedBatchNorm(h_dim), nn.ReLU(),
            nn.Dropout(dropout_rate), nn.Conv2d(h_dim, h_dim, 3),
        )
        self.vis_emb_fc1 = nn.Sequential(
            nn.Linear(v_dim, h_dim), nn.LayerNorm(h_dim), nn.ReLU(), nn.Dropout(dropout_rate),
            nn.Linear(h_dim, h_dim),
        )
        self.lang_emb_fc = nn.Sequential(
            nn.Linear(l_dim, h_dim), nn.LayerNorm(h_dim), nn.ReLU(), nn.Dropout(dropout_rate),
            nn.Linear(h_dim, h_dim),
        )
        self.cls = nn.Sequential(
            nn.Linear(h_dim, h_dim), MaskedBatchNorm(h_dim), nn.ReLU(), nn.Linear(h_dim, 9)
        )

    def forward(self, data_dict: dict) -> dict:
        out = dict(data_dict)
        pyramid = data_dict["scene_pyramid"]
        bsz = data_dict["cand_mask"].shape[0]

        feats = self.net(data_dict["scene_feats"], pyramid)  # [SV4, 128]
        final = pyramid[-1]
        crop = sparse_crop_mask(final, self.loc_min, self.loc_max)
        bev = self.to_bev[1](feats, final, crop, bsz)  # [B, 15, 25, 128]
        # sample_valid masks whole planes of loader-padded samples out of the
        # batch statistics (train mode)
        valid = data_dict.get("sample_valid")

        def plane_mask(hh, ww):
            return None if valid is None else valid[:, None, None].expand(bsz, hh, ww)

        bev = torch.relu(self.to_bev[2](bev, plane_mask(*bev.shape[1:3])))

        x = bev.permute(0, 3, 1, 2)  # NCHW
        x = self.vis_emb_fc[0](x)
        x = torch.relu(self.vis_emb_fc[1](x, plane_mask(*x.shape[2:]), channel_dim=1))
        x = self.vis_emb_fc[4](self.vis_emb_fc[3](x))  # [B, h, 11, 21]
        hh, ww = x.shape[2], x.shape[3]
        cells = x.flatten(2).transpose(1, 2)  # [B, 231, h]

        lang = self.lang_emb_fc(data_dict["lang_scene_feats"])  # [B, h]
        atten = torch.softmax(torch.einsum("bnh,bh->bn", cells, lang) / math.sqrt(self.h_dim), 1)
        out["vis_atten"] = atten.view(bsz, hh, ww)
        scene_feats = torch.einsum("bn,bnh->bh", atten, cells)

        s = torch.relu(self.cls[1](self.cls[0](scene_feats), valid))
        out["seg_scores"] = self.cls[3](s)
        obj = self.vis_emb_fc1(data_dict["obj_feats"])  # [B, C, h]
        out["scene_scores"] = cosine_similarity(obj, scene_feats[:, None, :], dim=-1)
        return out
