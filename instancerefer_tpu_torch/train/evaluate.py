"""Evaluation, counterpart of ``instancerefer_tpu/train/evaluate.get_eval``:
0 candidates -> zero box (a miss), 1 -> that candidate, >= 2 -> argmax of
the summed scores; ``ref_acc`` and Acc@IoU per sample.  ``get_loss`` runs
first (it produces ``cluster_label`` and ``ref_gt_obb``).  ``aggregate_scores``
is the eval CLI's host-side table, in numpy.  Data-parallel, the means and
``num_missed`` are those of the global batch (``train/losses.global_sums``);
the per-sample outputs stay the rank's own."""

from __future__ import annotations

import numpy as np
import torch

from instancerefer_tpu_torch.ops.boxes import box3d_iou_aabb, get_3d_box_corners
from instancerefer_tpu_torch.parallel.distributed import world_size
from instancerefer_tpu_torch.train.losses import global_sums


def get_eval(data_dict: dict) -> dict:
    out = dict(data_dict)
    lang_scores = data_dict["lang_scores"]
    valid = data_dict.get("sample_valid")
    if valid is None:
        valid = torch.ones(lang_scores.shape[0], dtype=torch.bool, device=lang_scores.device)
    vf = valid.float()
    n_valid = vf.sum().clamp(min=1.0)
    lang_correct = (lang_scores.argmax(1) == data_dict["object_cat"]).float()
    out["lang_correct"] = lang_correct

    scores = (data_dict["attribute_scores"] + data_dict["relation_scores"]
              + data_dict["scene_scores"])
    cand_mask = data_dict["cand_mask"]
    num_cand = cand_mask.sum(1)
    cluster_pred = torch.where(cand_mask, scores, torch.finfo(scores.dtype).min).argmax(1)
    target = data_dict["cluster_label"].argmax(1)
    first_valid = cand_mask.int().argmax(1)
    sel = torch.where(num_cand >= 2, cluster_pred, first_valid)
    pred_obb = torch.gather(
        data_dict["pred_obb_batch"], 1, sel[:, None, None].expand(-1, 1, 7)
    )[:, 0]
    pred_obb = torch.where((num_cand > 0)[:, None], pred_obb, 0.0)
    ref_gt_obb = data_dict["ref_gt_obb"]

    iou = box3d_iou_aabb(pred_obb, ref_gt_obb)
    ref_acc = torch.where(num_cand >= 2, (cluster_pred == target).float(), (iou > 0.25).float())
    out["ref_acc"] = ref_acc
    out["ref_iou"] = iou
    missed = (num_cand == 0) & valid
    hits = (lang_correct, ref_acc, iou >= 0.25, iou >= 0.5)
    if world_size() > 1:
        *sums, n_missed, n = global_sums([h * vf for h in hits] + [missed.float(), vf])
        means = [t / n.clamp(min=1.0) for t in sums]
        out["num_missed"] = n_missed.long()
    else:
        means = [(h * vf).sum() / n_valid for h in hits]
        out["num_missed"] = missed.sum()
    for key, mean in zip(("lang_acc", "ref_acc_mean", "ref_iou_rate_0.25", "ref_iou_rate_0.5"),
                         means):
        out[key] = mean
    out["ref_multiple_mask"] = data_dict["unique_multiple"]
    out["ref_others_mask"] = (data_dict["object_cat"] == 17).long()
    out["pred_bboxes"] = get_3d_box_corners(pred_obb)
    out["gt_bboxes"] = get_3d_box_corners(ref_gt_obb)
    out["sample_valid"] = valid
    return out


def aggregate_scores(ious, ref_acc, multiple, others) -> dict:
    """The unique/multiple x others table of the reference's
    ``scripts/eval.py:201-334``: {unique, multiple, overall} x
    {not_in_others, in_others, overall}, each cell with ref_acc, Acc@0.25,
    Acc@0.5 and its count (0 everywhere for an empty cell, as the reference)."""
    ious = np.asarray(ious)
    ref_acc = np.asarray(ref_acc)
    multiple = np.asarray(multiple).astype(bool)
    others = np.asarray(others).astype(bool)

    def cell(mask):
        if mask.sum() == 0:
            return {"ref_acc": 0.0, "acc@0.25iou": 0.0, "acc@0.5iou": 0.0, "count": 0}
        return {
            "ref_acc": float(ref_acc[mask].mean()),
            "acc@0.25iou": float((ious[mask] >= 0.25).mean()),
            "acc@0.5iou": float((ious[mask] >= 0.5).mean()),
            "count": int(mask.sum()),
        }

    all_mask = np.ones_like(multiple)
    rows = {"unique": ~multiple, "multiple": multiple, "overall": all_mask}
    cols = {"not_in_others": ~others, "in_others": others, "overall": all_mask}
    return {rk: {ck: cell(rm & cm) for ck, cm in cols.items()} for rk, rm in rows.items()}
