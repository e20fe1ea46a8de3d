"""Training CLI, counterpart of the JAX package's ``scripts/train.py``:

    python -m instancerefer_tpu_torch.scripts.train --config config/InstanceRefer.yaml \\
        --log_dir mylog [--device cpu]

Seeding (numpy and torch), a backup of the model, solver and dataset sources
into the run directory, the port's ``ScannetReferenceDataset``/
``PaddedLoader``, the model of the config, warm start
(``use_checkpoint`` resumes a run's ``checkpoint.tar``, ``--pretrain`` loads
a ``.pth``/``.tar``, ``use_pretrained`` copies the submodules of a run's
``model_last.pth``), predicted-class candidate filtering when
``use_gt_lang`` is off, ``info.json``, then the ``Solver``'s epoch loop.
``--device cuda`` (the default; it needs a card) or ``--device cpu``.

``model: pointgroup`` (``config/PointGroup.yaml``) trains PointGroup's first
phase instead (``train_pointgroup``): the scenes of the split files under
``{data_root}/scannet/meta_data`` whose exporter files
(``data/prepare.py``) lie under ``{data_root}/scannet/pointgroup_data``,
``data/pointgroup``'s batches, ``models/pointgroup.PointGroup`` and
``train/pointgroup.PointGroupSolver``.  One process: data parallelism is
not ported for it.

Data-parallel under ``torchrun`` (one process a card):

    torchrun --nproc_per_node N -m instancerefer_tpu_torch.scripts.train --config ...

Rank r takes ``cuda:LOCAL_RANK`` (nccl; gloo with ``--device cpu``) and
loads ``batch_size // N`` samples a step, its shard of both splits
(``batch_size`` is the global batch and must divide by N).  The weights are
built from ``manual_seed`` on every rank (DDP broadcasts rank 0's anyway);
then the default generator is seeded with ``manual_seed + rank``, so the
ranks draw different dropout masks, as JAX's positional masks differ over
the global array.  Rank 0 alone writes the run directory.  Without
``WORLD_SIZE`` in the environment (``python -m ...``) it runs one process.
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
from instancerefer_tpu_torch.parallel import distributed

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's sources a run backs up
BACKUP = (
    [f"models/{m}.py" for m in ("instancerefer", "lang_module", "attribute_module",
                                "relation_module", "scene_module")]
    + ["train/solver.py", "data/dataset.py"]
)
PG_BACKUP = ["models/pointgroup.py", "train/pointgroup.py", "train/solver.py",
             "data/pointgroup.py"]


def init_experiment(cfg: Config, stamp: str, backup=BACKUP) -> str:
    root = os.path.join(cfg.path_output, stamp)
    for rel in backup:
        dest = os.path.join(root, "backup", os.path.basename(_PORT), rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(os.path.join(_PORT, rel), dest)
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


def train_pointgroup(cfg: Config, device: torch.device):
    """PointGroup's first phase as ``cfg`` says; returns its solver."""
    from instancerefer_tpu_torch.data.pointgroup import PointGroupDataset, PointGroupLoader
    from instancerefer_tpu_torch.models.pointgroup import PointGroup, init_parameters
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.pointgroup import PointGroupSolver

    if distributed.world_size() > 1:
        raise ValueError("PointGroup trains in one process: data parallelism is not ported")
    set_compute_dtype(cfg.compute_dtype)
    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime())
    if cfg.log_dir:
        stamp += "_" + cfg.log_dir.upper()
    root = init_experiment(cfg, stamp, PG_BACKUP)
    spec = cfg.pg_spec()
    data = os.path.join(cfg.path_scannet, "pointgroup_data")
    datasets = {}
    for split in ("train", "val"):
        with open(os.path.join(cfg.path_scannet_meta, f"scannetv2_{split}.txt")) as f:
            ids = [line.strip() for line in f if line.strip()]
        datasets[split] = PointGroupDataset(data, ids[:cfg.num_scenes] if cfg.num_scenes > 0
                                            else ids, spec)
    print(f"train on {len(datasets['train'])} scenes, val on {len(datasets['val'])} scenes")
    loaders = {"train": PointGroupLoader(datasets["train"], cfg.batch_size, seed=cfg.manual_seed),
               "val": PointGroupLoader(datasets["val"], cfg.batch_size, shuffle=False,
                                       drop_last=False)}
    model = PointGroup(6, cfg.m, cfg.num_levels, cfg.block_reps, cfg.sem_classes, cfg.bn_eps)
    init_parameters(model, torch.Generator().manual_seed(cfg.manual_seed))
    solver = PointGroupSolver(model, spec, device, lr=cfg.lr, wd=cfg.wd,
                              lr_decay_step=cfg.lr_decay_step, lr_decay_rate=cfg.lr_decay_rate,
                              bn_decay_step=cfg.bn_decay_step, bn_decay_rate=cfg.bn_decay_rate,
                              stamp=stamp, output_dir=cfg.path_output, start_val=cfg.start_val)
    if cfg.use_checkpoint:
        solver.load_checkpoint(
            os.path.join(cfg.path_output, cfg.use_checkpoint, "checkpoint.tar"), with_opt=True)
    elif cfg.pretrain:
        solver.load_checkpoint(cfg.pretrain)
    info = {k: v for k, v in vars(cfg).items() if isinstance(v, (str, int, float, bool, list))}
    info.update(num_train=len(datasets["train"]), num_val=len(datasets["val"]), num_devices=1)
    with open(os.path.join(root, "info.json"), "w") as f:
        json.dump(info, f, indent=4)
    print("start training...\n")
    solver(loaders, cfg.epoch, cfg.verbose)
    return solver


def train(cfg: Config):
    """Train as ``cfg`` says; returns the ``Solver`` after its last epoch.
    Joins the process group of ``torchrun``'s environment, if any; the
    process that runs ``main`` as a script ends it."""
    device = distributed.init_from_env(cfg.torch_device())
    if cfg.model == "pointgroup":
        return train_pointgroup(cfg, device)
    if cfg.model != "instancerefer":
        raise ValueError(f"model {cfg.model!r} is neither instancerefer nor pointgroup")
    world, rank = distributed.world_size(), distributed.rank()
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over {world} ranks")

    def say(msg: str) -> None:  # rank 0 speaks for the run
        if rank == 0:
            print(msg)

    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype(cfg.compute_dtype)

    from instancerefer_tpu_torch.data.dataset import (
        PaddedLoader,
        PredictedClassLoader,
        ScannetReferenceDataset,
        get_scanrefer,
    )
    from instancerefer_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from instancerefer_tpu_torch.models.instancerefer import build_model
    from instancerefer_tpu_torch.train.solver import Solver

    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)

    stamp = time.strftime("%Y-%m-%d_%H-%M-%S", time.gmtime())
    if cfg.log_dir:
        stamp += "_" + cfg.log_dir.upper()
    root = init_experiment(cfg, stamp) if rank == 0 else None

    scanrefer_train = get_scanrefer(cfg.data_root, "train", cfg.num_scenes)
    scanrefer_val = get_scanrefer(cfg.data_root, "val", cfg.num_scenes)
    say(f"train on {len(scanrefer_train)} samples, val on {len(scanrefer_val)} samples")

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
    # each rank loads its shard of both splits, batch_size // world a step
    local_bs = cfg.batch_size // world
    loader_kw = dict(seed=cfg.manual_seed, num_workers=cfg.num_workers,
                     voxel_size_ap=cfg.voxel_size_ap, voxel_size_glp=cfg.voxel_size_glp,
                     process_index=rank, process_count=world)
    split_kw = {"train": dict(shuffle=True), "val": dict(shuffle=False, drop_last=False)}
    loaders = {
        phase: PaddedLoader(datasets[phase], spec, local_bs, **split_kw[phase], **loader_kw)
        for phase in ("train", "val")
    }

    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.manual_seed))
    torch.manual_seed(cfg.manual_seed + rank)  # the rank's dropout masks
    solver = Solver(
        model, dc.mean_size_arr, spec, device,
        lr=cfg.lr, wd=cfg.wd, lr_decay_step=cfg.lr_decay_step, lr_decay_rate=cfg.lr_decay_rate,
        bn_decay_step=cfg.bn_decay_step, bn_decay_rate=cfg.bn_decay_rate,
        stamp=stamp, output_dir=cfg.path_output, start_val=cfg.start_val,
    )

    if cfg.use_checkpoint:
        say(f"loading checkpoint {cfg.use_checkpoint}...")
        solver.load_checkpoint(
            os.path.join(cfg.path_output, cfg.use_checkpoint, "checkpoint.tar"), with_opt=True
        )
    elif cfg.pretrain:
        say(f"loading pretrained model {cfg.pretrain}...")
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
        say(f"warm-starting submodules from {cfg.use_pretrained}...")
        solver.load_pretrained_modules(os.path.join(cfg.use_pretrained, "model_last.pth"))

    if not cfg.use_gt_lang:
        # candidates filtered by the predicted class (reference
        # models/attribute_module.py:93-97), re-predicted with the current
        # language weights at the start of every epoch
        predict_fn = lang_predictor(solver.model, device)
        loaders = {
            phase: PredictedClassLoader(datasets[phase], spec, local_bs, predict_fn,
                                        **split_kw[phase], **loader_kw)
            for phase in ("train", "val")
        }

    if rank == 0:
        info = {k: v for k, v in vars(cfg).items() if isinstance(v, (str, int, float, bool, list))}
        info["num_train"] = len(scanrefer_train)
        info["num_val"] = len(scanrefer_val)
        info["num_devices"] = world
        with open(os.path.join(root, "info.json"), "w") as f:
            json.dump(info, f, indent=4)

    say("start training...\n")
    solver(loaders, cfg.epoch, cfg.verbose)
    return solver


def main(argv: Optional[List[str]] = None):
    return train(load_config(argv))


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
