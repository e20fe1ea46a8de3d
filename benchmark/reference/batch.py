"""A batch of generated scenes (``benchmark/scenes.Scene``) as the plain
reference reads it, worked out from the scenes alone, on any device.

The configuration's rules (``configs/<name>.json``), as the published
loader and model apply them:
* the first ``max_instances`` instances of a scene count; its candidates
  are the first ``max_candidates`` of them whose class is the described
  object's (``use_gt_lang``);
* a candidate's points are voxelized at ``voxel_size_ap`` and the scene's
  at ``voxel_size_glp``; only samples with two candidates or more run the
  instance encoder;
* an instance's relation feature is the mean of its points' features with
  xyz replaced by its box's center.

``caps_exceeded`` counts what the configuration's capacities would cut
(voxels of a stage beyond its cap a sample, instances, candidates): the
reference keeps them all, so a batch that exceeds a cap is not the one the
configuration runs.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.reference.voxels import pyramid, quantize

NUM_STAGES = 5


def feature_dim(cfg: dict) -> int:
    """The stems' input width: xyz, then rgb, normals, the 128 multiview
    channels and height where the configuration uses them."""
    return 3 + 3 * cfg["use_color"] + 3 * cfg["use_normal"] + 128 * cfg["use_multiview"] \
        + int(cfg["use_height"])


def prepare(scenes: List, cfg: dict, device) -> dict:
    b = len(scenes)
    m_cap, c_cap = int(cfg["max_instances"]), int(cfg["max_candidates"])
    t = max(s.lang_len for s in scenes)
    lang = np.zeros((b, t, scenes[0].lang_feat.shape[1]), np.float32)
    for i, s in enumerate(scenes):
        lang[i, :s.lang_len] = s.lang_feat[:s.lang_len]
    m = min(max(len(s.instance_points) for s in scenes), m_cap)
    fdim = scenes[0].point_cloud.shape[1]
    inst_class = np.zeros((b, m), np.int64)
    inst_obbs = np.zeros((b, m, 7), np.float32)
    inst_mask = np.zeros((b, m), bool)
    node = np.zeros((b, m, fdim), np.float32)
    cand_slot = np.zeros((b, c_cap), np.int64)
    cand_mask = np.zeros((b, c_cap), bool)
    exceeded = 0
    inst_xyz, inst_f, inst_g = [], [], []
    for i, s in enumerate(scenes):
        k = min(len(s.instance_points), m_cap)
        exceeded += len(s.instance_points) - k
        for j in range(k):
            inst_class[i, j] = s.instance_class[j]
            inst_obbs[i, j] = s.instance_obbs[j]
            node[i, j] = s.instance_points[j].astype(np.float64).mean(0)
            node[i, j, :3] = s.instance_obbs[j][:3]
        inst_mask[i, :k] = True
        matching = [j for j in range(k) if s.instance_class[j] == s.object_cat]
        total = matching + [j for j in range(k, len(s.instance_points))
                            if s.instance_class[j] == s.object_cat]
        exceeded += len(total) - min(len(matching), c_cap)
        cands = matching[:c_cap]
        cand_slot[i, :len(cands)] = cands
        cand_mask[i, :len(cands)] = True
        if len(cands) >= 2:
            for c, j in enumerate(cands):
                pts = s.instance_points[j]
                inst_xyz.append(pts[:, :3])
                inst_f.append(pts)
                inst_g.append(np.full(len(pts), i * c_cap + c, np.int64))

    def t_(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def voxels(xyz, feats, group, size):
        coords, grp, f = quantize(t_(np.concatenate(xyz)), t_(np.concatenate(feats)),
                                  t_(np.concatenate(group)), size)
        return f, pyramid(coords, grp, NUM_STAGES)

    if inst_xyz:
        inst_feats, inst_stages = voxels(inst_xyz, inst_f, inst_g, float(cfg["voxel_size_ap"]))
    else:
        inst_feats, inst_stages = t_(np.zeros((0, fdim), np.float32)), [
            _empty(device) for _ in range(NUM_STAGES)]
    scene_feats, scene_stages = voxels(
        [s.point_cloud[:, :3] for s in scenes], [s.point_cloud for s in scenes],
        [np.full(len(s.point_cloud), i, np.int64) for i, s in enumerate(scenes)],
        float(cfg["voxel_size_glp"]))
    for stages, cap_key, per in ((inst_stages, "inst_caps", c_cap), (scene_stages, "scene_caps", 1)):
        for st, cap in zip(stages, cfg[cap_key]):  # a cap holds a sample's rows
            rows = torch.bincount(torch.div(st.group, per, rounding_mode="floor"), minlength=b)
            exceeded += int((rows - cap).clamp(min=0).sum())
    pts = [s.point_cloud[:, :3] for s in scenes]
    return {
        "lang_feat": t_(lang), "lang_len": t_([s.lang_len for s in scenes], torch.long),
        "object_cat": t_([s.object_cat for s in scenes], torch.long),
        "inst_class": t_(inst_class), "inst_obbs": t_(inst_obbs), "inst_mask": t_(inst_mask),
        "node_feat": t_(node), "cand_slot": t_(cand_slot), "cand_mask": t_(cand_mask),
        "pred_obb": t_(np.take_along_axis(inst_obbs, cand_slot[..., None], 1)),
        "inst_feats": inst_feats, "inst_stages": inst_stages,
        "scene_feats": scene_feats, "scene_stages": scene_stages,
        "point_min": t_(np.stack([p.min(0) for p in pts])),
        "point_max": t_(np.stack([p.max(0) for p in pts])),
        "ref_center": t_(np.stack([s.ref_center_label for s in scenes])),
        "ref_size_class": t_([s.ref_size_class_label for s in scenes], torch.long),
        "ref_size_residual": t_(np.stack([s.ref_size_residual_label for s in scenes])),
        "unique_multiple": t_([s.unique_multiple for s in scenes], torch.long),
        "caps_exceeded": exceeded,
    }


def _empty(device):
    from benchmark.reference.voxels import Stage

    z = torch.zeros((0, 3), dtype=torch.long, device=device)
    e = torch.zeros((0,), dtype=torch.long, device=device)
    return Stage(z, e, 1, torch.zeros((0, 27), dtype=torch.long, device=device),
                 torch.zeros((0, 8), dtype=torch.long, device=device), e, e)


def conv_shapes(d: dict, cin: int):
    """(kind, valid entries, rows in, rows out, K, Cin, Cout) of every
    sparse conv of a forward over this batch's maps: per encoder the stem,
    then per stage the down conv and the residual block's two convs."""
    widths = (32, 64, 128, 128, 128)
    out = []
    for key in ("scene_stages", "inst_stages"):
        st = d[key]
        out.append(("stem", int((st[0].nbr >= 0).sum()), len(st[0].coords), len(st[0].coords),
                    27, cin, widths[0]))
        for s in range(1, NUM_STAGES):
            down = int((st[s].down >= 0).sum())
            out.append(("down", down, len(st[s - 1].coords), len(st[s].coords), 8,
                        widths[s - 1], widths[s]))
            nnz = int((st[s].nbr >= 0).sum())
            out += [("residual", nnz, len(st[s].coords), len(st[s].coords), 27, widths[s],
                     widths[s])] * 2
    return out
