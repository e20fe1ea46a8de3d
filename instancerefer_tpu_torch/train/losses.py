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
partial last batch).

The reference's unused variants (SoftmaxRankingLoss, RankingLoss,
SimCLRLoss, SegLoss, compute_box_loss) follow in the JAX package's masked
form, as plain autograd functions: its ``stop_gradient`` is ``detach``, its
``NEG_INF`` masks ``torch.where``."""

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


def cross_entropy(logits, labels):
    """[B, C] logits, [B] labels -> [B] per-row cross-entropies."""
    return F.cross_entropy(logits, labels, reduction="none")


def _masked_mean(values, valid):
    vf = valid.float()
    return (values * vf).sum() / vf.sum().clamp(min=1.0)


def _all_valid(values):
    return torch.ones(values.shape[0], dtype=torch.bool, device=values.device)


def compute_scene_mask_loss(data_dict, valid=None):
    """(CE over the 9 BEV regions, accuracy, region labels) of this
    process's batch, means over ``valid`` rows (lib/loss_helper.py:131-161)."""
    pred = data_dict["seg_scores"]
    label = scene_region_label(
        data_dict["ref_center_label"], data_dict["point_min"], data_dict["point_max"]
    )
    valid = _all_valid(pred) if valid is None else valid
    loss = _masked_mean(cross_entropy(pred, label), valid)
    acc = _masked_mean((pred.argmax(1) == label).float(), valid)
    return loss, acc, label


def compute_lang_classification_loss(data_dict, valid=None):
    """The language CE of this process's batch, a mean over ``valid`` rows."""
    ce = cross_entropy(data_dict["lang_scores"], data_dict["object_cat"])
    return _masked_mean(ce, _all_valid(ce) if valid is None else valid)


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
        valid = _all_valid(lang_scores)
    lang_ce = cross_entropy(lang_scores, data_dict["object_cat"])
    pred = data_dict["seg_scores"]
    region = scene_region_label(
        data_dict["ref_center_label"], data_dict["point_min"], data_dict["point_max"]
    )
    seg_ce = cross_entropy(pred, region)
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
    slots = torch.arange(cand_mask.shape[1], device=best.device)
    cluster_label = (best[:, None] == slots).float() * cand_mask

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


# ---------------------------------------------------------------------------
# the reference's unused loss variants (instancerefer_tpu/train/losses.py:175-238)
# ---------------------------------------------------------------------------

def softmax_ranking_loss(inputs, targets, mask):
    """lib/loss_helper.py:17-30: the softmax over axis 0, as the reference."""
    logits = torch.where(mask, inputs + 1e-8, NEG_INF)
    probs = torch.softmax(logits, dim=0)
    return (-(torch.log(probs + 1e-8) * targets * mask).sum(0)).mean()


def simclr_loss(sim, label, mask, temp: float = 7.0):
    """lib/loss_helper.py:78-90 in masked form."""
    e = torch.where(mask, torch.exp(temp * sim), 0.0)
    pos = (e * label).sum()
    return -torch.log(pos / (e.sum() - pos + 1e-8))


def ranking_loss(sim, label, mask, m: float = 0.2, gamma: float = 64.0):
    """Circle-loss style RankingLoss (lib/loss_helper.py:33-75), per sample
    over the last axis; a sample with more than 20 negatives keeps its 10
    largest (ranked by how many negatives are strictly larger)."""
    delta_p, delta_n = 1 - m, m
    pos_mask = mask & (label > 0.5)
    neg_mask = mask & (label < 0.25)

    alpha_p = (0.8 - sim.detach()).clamp(min=0.0)
    logit_p = torch.where(pos_mask, -alpha_p * (sim - delta_p) * gamma, NEG_INF)
    lse_p = torch.where(pos_mask.any(-1), torch.logsumexp(logit_p, dim=-1), 0.0)

    n_neg = neg_mask.sum(-1, keepdim=True)
    neg_sim = torch.where(neg_mask, sim, NEG_INF)
    rank = (neg_sim[..., None, :] > neg_sim[..., :, None]).sum(-1)
    keep = neg_mask & ((n_neg <= 20) | (rank < 10))
    alpha_n = (sim.detach() - 0.2).clamp(min=0.0)
    logit_n = torch.where(keep, alpha_n * (sim - delta_n) * gamma, NEG_INF)
    lse_n = torch.logsumexp(logit_n, dim=-1)
    x = lse_n + lse_p
    return torch.logaddexp(x, torch.zeros_like(x)).mean()


def seg_focal_loss(preds, labels, mask, alpha: float = 0.25, gamma: float = 2.0):
    """Focal BCE SegLoss (lib/loss_helper.py:110-128), masked."""
    logpt = -(preds.clamp(min=0) - preds * labels + torch.log1p(torch.exp(-preds.abs())))
    logpt = torch.where(mask, logpt, 0.0).sum() / mask.sum().clamp(min=1.0)
    pt = torch.exp(logpt)
    return -((1 - pt) ** gamma) * alpha * logpt


def compute_box_loss(pred_center, pred_size_residual, gt_center, gt_size_residual, box_mask):
    """Smooth-L1 center/size losses (lib/loss_helper.py:164-186)."""

    def smooth_l1(x):
        a = x.abs()
        return torch.where(a < 1.0, 0.5 * x * x, a - 0.5)

    denom = box_mask.sum() + 1e-6
    center_loss = (smooth_l1(pred_center - gt_center) * box_mask[:, None]).sum() / denom
    size_loss = (smooth_l1(pred_size_residual - gt_size_residual) * box_mask[:, None]).sum() / denom
    return center_loss, size_loss
