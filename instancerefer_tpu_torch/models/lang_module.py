"""Language encoder, counterpart of ``instancerefer_tpu/models/lang_module.py``:
GloVe projection, 2-layer GRU masked to each description's length
(``ops/gru.static_gru``; bidirectional unless ``use_bidir=False``, as the
config's ``use_bidir``), four attention heads that
pool the *projected embeddings* (not the GRU states, a reference quirk) and
the 18-way text classifier.  The word dropout is live
in train mode; the GRU's backward is cuDNN's on the card."""

from __future__ import annotations

import torch
from torch import nn

from instancerefer_tpu_torch.ops.gru import length_mask, static_gru


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return torch.where(mask, torch.softmax(logits, dim=dim), 0.0)


class LangModule(nn.Module):
    HEADS = ("fc_a", "fc_cls", "fc_rel", "fc_scene")

    def __init__(self, num_text_classes: int, use_bidir: bool = True, emb_size: int = 300,
                 hidden_size: int = 128, word_dropout: float = 0.1):
        super().__init__()
        h_dim = 256
        self.word_projection = nn.Sequential(
            nn.Linear(emb_size, h_dim), nn.ReLU(), nn.Dropout(word_dropout),
            nn.Linear(h_dim, h_dim), nn.ReLU(),
        )
        self.gru = nn.GRU(h_dim, hidden_size, num_layers=2, batch_first=True,
                          bidirectional=use_bidir)
        for name in self.HEADS:
            setattr(self, name, nn.Linear(hidden_size * (1 + use_bidir), 1))
        self.lang_cls = nn.Sequential(nn.Linear(h_dim, num_text_classes))

    def forward(self, data_dict: dict) -> dict:
        feats = data_dict["lang_feat"]  # [B, T, 300]
        lengths = data_dict["lang_len"]  # [B]
        t = feats.shape[1]
        embed = self.word_projection(feats)
        gru_out = static_gru(self.gru, embed, lengths)  # [B, T, 128 * (1 + bidir)]
        mask = length_mask(lengths, t)

        out = dict(data_dict)
        out["lang_feat"] = gru_out
        pooled = {}
        for name in self.HEADS:
            atten = masked_softmax(getattr(self, name)(gru_out).squeeze(-1), mask, dim=1)
            pooled[name] = (atten, torch.einsum("bt,btc->bc", atten, embed))
        out["atten_attr"] = pooled["fc_a"][0]
        out["atten_rel"] = pooled["fc_rel"][0]
        out["atten_scene"] = pooled["fc_scene"][0]
        out["lang_cls_feats"] = pooled["fc_cls"][1]
        out["lang_attr_feats"] = pooled["fc_a"][1]
        out["lang_rel_feats"] = pooled["fc_rel"][1]
        out["lang_scene_feats"] = pooled["fc_scene"][1]
        out["lang_scores"] = self.lang_cls(pooled["fc_cls"][1])
        return out
