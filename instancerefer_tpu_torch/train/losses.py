"""Losses, counterpart of what ``instancerefer_tpu/train/losses.get_loss``
reaches: the masked ContrastiveLoss (margin 0.2, gamma 5, the positive enters
the negatives' logsumexp as a zero logit), the skip rules (>= 2 candidates
and max IoU >= 0.2), the 9-region scene CE and the language CE;
total = 10 * ref + lang + seg.

Every mean is over the valid samples of the global batch: data-parallel
(world size > 1), the ranks' masked sums and valid counts are added in one
differentiable ``all_reduce_sum``, so each rank holds the global loss, and
the backward of that all-reduce gives each rank ``world`` times its share of
the gradient, which ``DistributedDataParallel``'s average turns into the
gradient of the global-batch mean (``parallel/distributed``).  A mean of the
ranks' local means would be wrong wherever their valid counts differ (a
partial last batch)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from instancerefer_tpu_torch.ops.boxes import box3d_iou_aabb, param2obb
from instancerefer_tpu_torch.parallel.distributed import all_reduce_sum, world_size

NEG_INF = -1e30


def contrastive_loss_masked(score, label, mask, margin: float = 0.2, gamma: float = 5.0):
    """score/label [B, C] (label one-hot float), mask [B, C] -> [B] losses."""
    s = score * gamma
    sim = (s * label * mask).sum(1)
    zero_or_pad = torch.where(mask, 0.0, NEG_INF)
    neg_logits = torch.where(mask & (label < 0.5), s, zero_or_pad)
    return (torch.logsumexp(neg_logits, dim=1) - sim + margin).clamp(min=0.0)


def scene_region_label(ref_center, point_min, point_max):
    """9-region label truth table (reference lib/loss_helper.py:142-153)."""
    first = point_min + (point_max - point_min) / 3.0
    second = point_min + (point_max - point_min) / 3.0 * 2.0
    rf, rs = ref_center <= first, ref_center <= second
    rf0, rf1, rs0, rs1 = rf[:, 0], rf[:, 1], rs[:, 0], rs[:, 1]
    label = torch.where(rf0 & rf1, 0, 4)
    label = torch.where(~rf0 & rs0 & rf1, 1, label)
    label = torch.where(~rs0 & rf1, 2, label)
    label = torch.where(rf0 & ~rf1 & rs1, 3, label)
    label = torch.where(~rs0 & ~rf1 & rs1, 5, label)
    label = torch.where(rf0 & ~rs1, 6, label)
    label = torch.where(~rf0 & rs0 & ~rs1, 7, label)
    label = torch.where(~rs0 & ~rs1, 8, label)
    return label


def _masked_mean(values, valid):
    vf = valid.float()
    return (values * vf).sum() / vf.sum().clamp(min=1.0)


def global_sums(terms):
    """The sum of each per-sample term over the global batch: every rank's
    sums in one all-reduce, differentiable."""
    return all_reduce_sum(torch.stack([t.sum() for t in terms]))


def get_loss(data_dict: dict, mean_size_arr: torch.Tensor) -> dict:
    """Returns the dict plus loss keys, ``cluster_label`` ([B, C] one-hot of
    the IoU argmax over valid candidates), ``cluster_label_mask`` and
    ``ref_gt_obb``; ``sample_valid`` (if present) restricts every mean."""
    out = dict(data_dict)
    lang_scores = data_dict["lang_scores"]
    valid = data_dict.get("sample_valid")
    if valid is None:
        valid = torch.ones(lang_scores.shape[0], dtype=torch.bool, device=lang_scores.device)
    lang_ce = F.cross_entropy(lang_scores, data_dict["object_cat"], reduction="none")
    pred = data_dict["seg_scores"]
    region = scene_region_label(
        data_dict["ref_center_label"], data_dict["point_min"], data_dict["point_max"]
    )
    seg_ce = F.cross_entropy(pred, region, reduction="none")
    seg_hit = (pred.argmax(1) == region).float()

    ref_gt_obb = param2obb(
        data_dict["ref_center_label"], data_dict["ref_heading_class_label"],
        data_dict["ref_heading_residual_label"], data_dict["ref_size_class_label"],
        data_dict["ref_size_residual_label"], mean_size_arr,
    )
    out["ref_gt_obb"] = ref_gt_obb
    cand_mask = data_dict["cand_mask"]
    num_cand = cand_mask.sum(1)
    ious = box3d_iou_aabb(data_dict["pred_obb_batch"], ref_gt_obb[:, None, :])
    ious = torch.where(cand_mask, ious, -1.0)
    max_iou = ious.amax(1)
    best = ious.argmax(1)  # first maximum, as jnp.argmax
    cluster_label = F.one_hot(best, cand_mask.shape[1]).float() * cand_mask

    per_sample = contrastive_loss_masked(
        data_dict["attribute_scores"] + data_dict["relation_scores"]
        + data_dict["scene_scores"],
        cluster_label, cand_mask,
    )
    use = (num_cand >= 2) & (max_iou >= 0.2) & valid
    ref_terms = torch.where(use, per_sample, 0.0)
    if world_size() > 1:
        vf = valid.float()
        *sums, n = global_sums((lang_ce * vf, seg_ce * vf, seg_hit * vf, ref_terms, vf))
        lang_loss, seg_loss, seg_acc, ref_loss = (t / n.clamp(min=1.0) for t in sums)
    else:
        lang_loss = _masked_mean(lang_ce, valid)
        seg_loss = _masked_mean(seg_ce, valid)
        seg_acc = _masked_mean(seg_hit, valid)
        ref_loss = ref_terms.sum() / valid.float().sum().clamp(min=1.0)

    out["ref_loss"] = ref_loss
    out["lang_loss"] = lang_loss
    out["seg_loss"] = seg_loss
    out["seg_acc"] = seg_acc
    out["loss"] = 10.0 * ref_loss + lang_loss + seg_loss
    out["cluster_label"] = cluster_label
    out["cluster_label_mask"] = num_cand > 0
    out["scene_region_label"] = region
    return out
