"""Evaluation CLI, counterpart of the JAX package's ``scripts/eval.py``:

    python -m instancerefer_tpu_torch.scripts.eval --config config/InstanceRefer.yaml \\
        --log_dir mylog [--device cpu]

Scores the val split with a run's ``model_last.pth`` (the reference's
``scripts/eval.py:54``), caches the per-sample scores in the run directory
(``scores.npz``), and prints the unique/multiple x others Acc@0.25/0.5 table.
A cached run prints its table without touching the model.  Capacity overflow
at eval fails the run before anything is cached, unless
``--allow_overflow`` is given.  On a card each batch replays the eval step's
CUDA graph of its language grid (``train/step_graph.StepGraphs``); on the
CPU the step runs eagerly.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from instancerefer_tpu_torch.config import Config, load_config

SCORE_KEYS = ("ref_iou", "ref_acc", "multiple", "others", "lang_correct", "pred_bboxes",
              "gt_bboxes")


def resolve_run_dir(cfg: Config) -> str:
    """The training run holding ``model_last.pth``: ``--log_dir`` as a run
    directory, else the newest stamped run of that experiment, else the
    newest run whose stamp ends in the log_dir.  Fails, listing the runs that
    exist, rather than evaluating another run's weights."""
    candidates = []
    if os.path.isfile(os.path.join(cfg.log_dir, "model_last.pth")):
        candidates.append(os.path.join(cfg.log_dir, "model_last.pth"))
    candidates += sorted(glob.glob(os.path.join(cfg.path_output, "*", "model_last.pth")),
                         reverse=True)
    candidates += sorted(
        glob.glob(os.path.join(cfg.output_root, cfg.dataset, "*", "checkpoints",
                               "*_" + cfg.log_dir.upper(), "model_last.pth")),
        reverse=True,
    )
    if candidates:
        run = os.path.dirname(candidates[0])
        print(f"evaluating run: {run}")
        return run
    others = sorted(glob.glob(os.path.join(cfg.output_root, cfg.dataset, "*", "checkpoints",
                                           "*", "model_last.pth")))
    hint = ("\n  runs that do exist (pass one as --log_dir):\n    "
            + "\n    ".join(os.path.dirname(o) for o in others)) if others else ""
    raise FileNotFoundError(
        f"no trained run with model_last.pth found for log_dir={cfg.log_dir!r} "
        f"under {cfg.path_output!r}{hint}"
    )


def check_eval_overflow(overflow_max: dict, allow: bool):
    """Fail when eval data overflowed a padded capacity: the reference
    evaluates ragged, uncapped lists (``lib/dataset.py:207-245``), so a
    truncated candidate or voxel changes the metric silently.
    ``overflow_max``: {"scene"/"inst"/"cand": the largest per-sample overflow
    fraction seen}.  ``allow`` downgrades the failure to a warning."""
    bad = {k: v for k, v in overflow_max.items() if v > 0}
    if not bad:
        return
    msg = (
        "capacity overflow at eval — padded caps truncated data the "
        f"reference would keep (max per-sample overflow fraction: {bad}). "
        "Fit the caps to this dataset (python -m instancerefer_tpu_torch.scripts.fit_caps "
        "--config <config> --data_root <root> --fit-caps --emit-yaml <profile>, then point "
        "the config's band_profile at it), "
        "or re-run with --allow_overflow to accept the deviation."
    )
    if allow:
        print(f"WARNING: {msg}")
    else:
        raise SystemExit(f"ERROR: {msg}")


def score(cfg: Config, root: str, device: torch.device) -> dict:
    """Per-sample scores of the val split (valid rows only)."""
    from instancerefer_tpu_torch.data.dataset import (
        PaddedLoader,
        PredictedClassLoader,
        ScannetReferenceDataset,
        get_scanrefer,
    )
    from instancerefer_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.models.instancerefer import build_model
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.scripts.train import lang_predictor
    from instancerefer_tpu_torch.train.step_graph import choose, eval_body
    from instancerefer_tpu_torch.utils.convert import load_reference_state_dict

    set_compute_dtype(cfg.compute_dtype)
    scanrefer_val = get_scanrefer(cfg.data_root, "val", cfg.num_scenes)
    print(f"evaluating on {len(scanrefer_val)} samples...")
    dc = ScannetDatasetConfig(meta_dir=cfg.path_scannet_meta)
    spec = cfg.batch_spec()
    dataset = ScannetReferenceDataset(
        scanrefer_val, "val", data_root=cfg.data_root, num_points=cfg.num_points,
        use_color=cfg.use_color, use_height=cfg.use_height, use_normal=cfg.use_normal,
        use_multiview=cfg.use_multiview, use_augment=False, seed=cfg.seed, dc=dc,
    )
    loader_kw = dict(shuffle=False, num_workers=cfg.num_workers, drop_last=False,
                     voxel_size_ap=cfg.voxel_size_ap, voxel_size_glp=cfg.voxel_size_glp)

    model = build_model(cfg)
    load_reference_state_dict(
        model, torch.load(os.path.join(root, "model_last.pth"), map_location="cpu",
                          weights_only=True))
    model = model.to(device).eval()
    mean_size = torch.tensor(dc.mean_size_arr, dtype=torch.float32, device=device)

    overrides = None
    if not cfg.use_gt_lang:
        # two passes: the reference filters candidates by argmax(lang_scores)
        # (models/attribute_module.py:93-97); pass 1 runs the language module
        # alone over the descriptions, pass 2 builds the batches with the
        # predicted classes
        pcl = PredictedClassLoader(dataset, spec, cfg.batch_size,
                                   lang_predictor(model, device), **loader_kw)
        overrides = pcl._predict_overrides()
        print(f"pass 1 done: predicted classes for {len(overrides)} samples")
    loader = PaddedLoader(dataset, spec, cfg.batch_size, class_overrides=overrides, **loader_kw)
    graphs, path = choose(model, None, mean_size)
    print("eval steps: " + path)

    results = {k: [] for k in SCORE_KEYS}
    overflow_max = {"scene": 0.0, "inst": 0.0, "cand": 0.0}
    for batch in loader:
        valid = batch.pop("sample_valid", np.ones(cfg.batch_size, bool))
        for key in overflow_max:
            ov = batch.get(f"{key}_overflow")
            if ov is not None:
                overflow_max[key] = max(overflow_max[key], float(np.asarray(ov)[valid].max()))
        if graphs is not None:
            _, out = graphs.eval_step(graphs.load(batch, spec, "eval"))
        else:
            out = eval_body(model, batch_to_torch(batch, spec, device), mean_size)[1]
        res = {"ref_iou": out["ref_iou"], "ref_acc": out["ref_acc"],
               "multiple": out["ref_multiple_mask"], "others": out["ref_others_mask"],
               "lang_correct": out["lang_correct"], "pred_bboxes": out["pred_bboxes"],
               "gt_bboxes": out["gt_bboxes"]}
        for k, v in res.items():
            results[k].append(v.cpu().numpy()[valid])
    # gate BEFORE caching: an overflowing run must not leave a cache that
    # short-circuits later (gated) evals
    check_eval_overflow(overflow_max, cfg.allow_overflow)
    res = {k: np.concatenate(v) for k, v in results.items()}
    res["lang_acc"] = res["lang_correct"]
    return res


def eval_ref(cfg: Config) -> dict:
    """Score (or read the cached scores of) a run; print and return the table."""
    from instancerefer_tpu_torch.train.evaluate import aggregate_scores

    device = cfg.torch_device()
    root = resolve_run_dir(cfg)
    cache_path = os.path.join(root, "scores.npz")
    if os.path.exists(cache_path):
        print(f"loading cached scores from {cache_path}...")
        res = dict(np.load(cache_path))
    else:
        res = score(cfg, root, device)
        np.savez(cache_path, **res)

    table = aggregate_scores(res["ref_iou"], res["ref_acc"], res["multiple"], res["others"])
    print(json.dumps(table, indent=2))
    print(f"lang_acc: {float(np.mean(res['lang_acc'])):.4f}")
    overall = table["overall"]["overall"]
    print(
        f"overall: ref_acc={overall['ref_acc']:.4f} "
        f"acc@0.25={overall['acc@0.25iou']:.4f} acc@0.5={overall['acc@0.5iou']:.4f}"
    )
    return table


def main(argv: Optional[List[str]] = None) -> dict:
    return eval_ref(load_config(argv))


if __name__ == "__main__":
    main()
