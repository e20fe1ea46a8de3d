"""Training CLI, counterpart of the JAX package's ``scripts/train.py``:

    python -m instancerefer_tpu_torch.scripts.train --config config/InstanceRefer.yaml \\
        --log_dir mylog [--device cpu]

Seeding (numpy and torch), a backup of the model and solver sources into the
run directory, the shared ``ScannetReferenceDataset``/``PaddedLoader``
(reached through the host bridge), the model of the config, warm start
(``use_checkpoint`` resumes a run's ``checkpoint.tar``, ``--pretrain`` loads
a ``.pth``/``.tar``, ``use_pretrained`` copies the submodules of a run's
``model_last.pth``), predicted-class candidate filtering when
``use_gt_lang`` is off, ``info.json``, then the ``Solver``'s epoch loop.
One process, one device: ``--device cuda`` (the default; it needs a card)
or ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from instancerefer_tpu_torch.config import Config, load_config

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (package directory, file) of the sources a run backs up
BACKUP = (
    [(_PORT, f"models/{m}.py") for m in ("instancerefer", "lang_module", "attribute_module",
                                          "relation_module", "scene_module")]
    + [(_PORT, "train/solver.py"),
       (os.path.join(os.path.dirname(_PORT), "instancerefer_tpu"), "data/dataset.py")]
)


def init_experiment(cfg: Config, stamp: str) -> str:
    root = os.path.join(cfg.path_output, stamp)
    backup = os.path.join(root, "backup")
    for pkg, rel in BACKUP:
        dest = os.path.join(backup, os.path.basename(pkg), rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(os.path.join(pkg, rel), dest)
    return root


def lang_predictor(model, device):
    """``predict_fn`` of ``PredictedClassLoader``: the class the language
    module (eval mode, current weights) gives each description."""

    def predict_fn(lang_feat: np.ndarray, lang_len: np.ndarray) -> np.ndarray:
        lang = model.lang
        was_training = lang.training
        lang.eval()
        try:
            with torch.no_grad():
                out = lang({"lang_feat": torch.from_numpy(np.ascontiguousarray(lang_feat)).to(device),
                            "lang_len": torch.from_numpy(np.asarray(lang_len, np.int64)).to(device)})
        finally:
            lang.train(was_training)
        return out["lang_scores"].argmax(1).cpu().numpy()

    return predict_fn


def train(cfg: Config):
    """Train as ``cfg`` says; returns the ``Solver`` after its last epoch."""
    device = cfg.torch_device()

    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype(cfg.compute_dtype)

    import instancerefer_tpu_torch.data.host  # noqa: F401  (the bridge dataset.py needs)
    from instancerefer_tpu.data.dataset import (
        PaddedLoader,
        PredictedClassLoader,
        ScannetReferenceDataset,
        get_scanrefer,
    )
    from instancerefer_tpu.data.scannet_config import ScannetDatasetConfig
    from instancerefer_tpu_torch.models.instancerefer import build_model
    from instancerefer_tpu_torch.train.solver import Solver

    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)

    stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime())
    if cfg.log_dir:
        stamp += "_" + cfg.log_dir.upper()
    root = init_experiment(cfg, stamp)

    scanrefer_train = get_scanrefer(cfg.data_root, "train", cfg.num_scenes)
    scanrefer_val = get_scanrefer(cfg.data_root, "val", cfg.num_scenes)
    print(f"train on {len(scanrefer_train)} samples, val on {len(scanrefer_val)} samples")

    dc = ScannetDatasetConfig(meta_dir=cfg.path_scannet_meta)
    spec = cfg.batch_spec()

    def make_ds(scanrefer, split):
        return ScannetReferenceDataset(
            scanrefer, split, data_root=cfg.data_root, num_points=cfg.num_points,
            use_color=cfg.use_color, use_height=cfg.use_height, use_normal=cfg.use_normal,
            use_multiview=cfg.use_multiview, use_augment=cfg.use_augment, seed=cfg.seed, dc=dc,
        )

    # one dataset per split, shared by the plain and predicted-class loaders
    datasets = {"train": make_ds(scanrefer_train, "train"), "val": make_ds(scanrefer_val, "val")}
    loader_kw = dict(seed=cfg.manual_seed, num_workers=cfg.num_workers,
                     voxel_size_ap=cfg.voxel_size_ap, voxel_size_glp=cfg.voxel_size_glp)
    split_kw = {"train": dict(shuffle=True), "val": dict(shuffle=False, drop_last=False)}
    loaders = {
        phase: PaddedLoader(datasets[phase], spec, cfg.batch_size, **split_kw[phase], **loader_kw)
        for phase in ("train", "val")
    }

    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.manual_seed))
    solver = Solver(
        model, dc.mean_size_arr, spec, device,
        lr=cfg.lr, wd=cfg.wd, lr_decay_step=cfg.lr_decay_step, lr_decay_rate=cfg.lr_decay_rate,
        bn_decay_step=cfg.bn_decay_step, bn_decay_rate=cfg.bn_decay_rate,
        stamp=stamp, output_dir=cfg.path_output, start_val=cfg.start_val,
    )

    if cfg.use_checkpoint:
        print(f"loading checkpoint {cfg.use_checkpoint}...")
        solver.load_checkpoint(
            os.path.join(cfg.path_output, cfg.use_checkpoint, "checkpoint.tar"), with_opt=True
        )
    elif cfg.pretrain:
        print(f"loading pretrained model {cfg.pretrain}...")
        solver.load_checkpoint(cfg.pretrain)
    elif cfg.use_pretrained:
        # the reference option is a run's name or path: `use_pretrained: True`
        # would otherwise train from random weights while the user believes
        # they warm-started
        if not isinstance(cfg.use_pretrained, str):
            raise ValueError(
                "use_pretrained must be the pretrained run's name/path "
                f"(a string), got {cfg.use_pretrained!r}"
            )
        print(f"warm-starting submodules from {cfg.use_pretrained}...")
        solver.load_pretrained_modules(os.path.join(cfg.use_pretrained, "model_last.pth"))

    if not cfg.use_gt_lang:
        # candidates filtered by the predicted class (reference
        # models/attribute_module.py:93-97), re-predicted with the current
        # language weights at the start of every epoch
        predict_fn = lang_predictor(solver.model, device)
        loaders = {
            phase: PredictedClassLoader(datasets[phase], spec, cfg.batch_size, predict_fn,
                                        **split_kw[phase], **loader_kw)
            for phase in ("train", "val")
        }

    info = {k: v for k, v in vars(cfg).items() if isinstance(v, (str, int, float, bool, list))}
    info["num_train"] = len(scanrefer_train)
    info["num_val"] = len(scanrefer_val)
    info["num_devices"] = 1
    with open(os.path.join(root, "info.json"), "w") as f:
        json.dump(info, f, indent=4)

    print("start training...\n")
    solver(loaders, cfg.epoch, cfg.verbose)
    return solver


def main(argv: Optional[List[str]] = None):
    return train(load_config(argv))


if __name__ == "__main__":
    main()
