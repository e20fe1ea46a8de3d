"""The published losses and scores (``lib/loss_helper.py``,
``lib/eval_helper.py`` of InstanceRefer), plain: the contrastive reference
loss (margin 0.2, gamma 5) over samples with two candidates or more whose
best box overlaps the target by IoU 0.2 or more, the language CE, the
9-region scene CE; total = 10 ref + lang + seg.  Boxes are axis-aligned
(ScanNet's have no heading)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _minmax(obb):
    return obb[..., :3] - obb[..., 3:6] / 2, obb[..., :3] + obb[..., 3:6] / 2


def box_iou(a, b, eps: float = 1e-8):
    amin, amax = _minmax(a)
    bmin, bmax = _minmax(b)
    inter = (torch.minimum(amax, bmax) - torch.maximum(amin, bmin)).clamp(min=0).prod(-1)
    return inter / ((amax - amin).prod(-1) + (bmax - bmin).prod(-1) - inter + eps)


def region_label(center, pmin, pmax):
    """Which ninth of the scene's xy extent holds the target's center."""
    third = (pmax - pmin) / 3.0
    col = (center[:, 0] > pmin[:, 0] + third[:, 0]).long() + \
        (center[:, 0] > pmin[:, 0] + 2 * third[:, 0]).long()
    row = (center[:, 1] > pmin[:, 1] + third[:, 1]).long() + \
        (center[:, 1] > pmin[:, 1] + 2 * third[:, 1]).long()
    return row * 3 + col


def loss_and_eval(out: dict, d: dict, mean_size: torch.Tensor, valid=None) -> dict:
    """The losses and the eval results of a batch's scores; ``valid`` masks
    the samples that count (all by default)."""
    cand = d["cand_mask"]
    b = cand.shape[0]
    valid = torch.ones(b, dtype=torch.bool, device=cand.device) if valid is None else valid
    vf = valid.float()
    n = vf.sum().clamp(min=1.0)
    size = mean_size[d["ref_size_class"]] + d["ref_size_residual"]
    gt = torch.cat([d["ref_center"], size, torch.zeros_like(size[:, :1])], -1)
    ious = torch.where(cand, box_iou(d["pred_obb"], gt[:, None]), -1.0)
    best = ious.argmax(1)
    label = F.one_hot(best, cand.shape[1]).float() * cand
    score = out["attribute_scores"] + out["relation_scores"] + out["scene_scores"]
    s = score * 5.0
    # the target enters the logsumexp as a zero logit; padding as -1e30
    neg = torch.where(cand & (label < 0.5), s, torch.where(cand, 0.0, -1e30))
    contrastive = (torch.logsumexp(neg, 1) - (s * label).sum(1) + 0.2).clamp(min=0.0)
    use = (cand.sum(1) >= 2) & (ious.amax(1) >= 0.2) & valid
    ref_loss = torch.where(use, contrastive, 0.0).sum() / n
    lang_loss = (F.cross_entropy(out["lang_scores"], d["object_cat"], reduction="none") * vf).sum() / n
    region = region_label(d["ref_center"], d["point_min"], d["point_max"])
    seg_loss = (F.cross_entropy(out["seg_scores"], region, reduction="none") * vf).sum() / n
    num = cand.sum(1)
    pick = torch.where(cand, score, float("-inf")).argmax(1)
    sel = torch.where(num >= 2, pick, cand.int().argmax(1))
    pred = torch.gather(d["pred_obb"], 1, sel[:, None, None].expand(-1, 1, 7))[:, 0]
    iou = torch.where(num > 0, box_iou(pred, gt), 0.0)
    return {
        "loss": 10.0 * ref_loss + lang_loss + seg_loss, "ref_loss": ref_loss,
        "lang_loss": lang_loss, "seg_loss": seg_loss, "score": score, "pick": pick,
        "ref_acc": torch.where(num >= 2, (pick == best).float(), (iou > 0.25).float()),
        "ref_iou": iou,
    }
