"""The port's eval CLI (``instancerefer_tpu_torch/scripts/eval.py``) against
the JAX model on the same weights and the same batches.

JAX weights (BN statistics moved off their defaults) are written as a
reference-layout ``model_last.pth`` into a run directory of a fake ScanRefer
root (``tests/fake_scanrefer.make_fake_root``: 6 val descriptions, so batches
of 4 end in a padded one).  The port's CLI scores the val split on the CPU in
f32; JAX runs ``apply`` + ``get_loss`` + ``get_eval`` over the same
``PaddedLoader`` batches, built in the port's raster row order
(``pallas_conv=True``) and run through JAX's XLA path.  ``scores.npz`` holds the valid rows only:
``ref_iou`` agrees at rtol 1e-4 / atol 1e-5, ``ref_acc``, ``lang_correct``,
``multiple`` and ``others`` are equal, and so is the Acc table.  A second run
reads the cache.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data.dataset import PaddedLoader, ScannetReferenceDataset, get_scanrefer
from instancerefer_tpu.data.pipeline import BatchSpec, batch_to_device_dict
from instancerefer_tpu.data.scannet_config import ScannetDatasetConfig
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.train.evaluate import aggregate_scores as jax_aggregate
from instancerefer_tpu.train.evaluate import get_eval as jax_eval
from instancerefer_tpu.train.losses import get_loss as jax_loss
from instancerefer_tpu.utils.convert_torch import export_state_dict

from instancerefer_tpu_torch.config import load_config
from instancerefer_tpu_torch.ops import precision
from instancerefer_tpu_torch.scripts import eval as eval_cli
from instancerefer_tpu_torch.train.evaluate import aggregate_scores

from fake_scanrefer import make_fake_root
from test_torch_modules import perturb_stats

TINY = """
GENERAL:
  manual_seed: 123
DATA:
  num_points: 500
TRAIN:
  batch_size: 4
  num_workers: 1
TPU:
  allow_overflow: True
  compute_dtype: float32
  pallas_conv: False
  max_des_len: 16
  lang_bucket: 8
  max_instances: 8
  max_candidates: 4
  scene_caps: [256, 128, 64, 32, 16]
  inst_caps: [256, 128, 64, 32, 16]
"""
STAMP = "2026-01-01_00-00-00_EVALRUN"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr")
    make_fake_root(root, np.random.default_rng(0))
    (root / "tiny.yaml").write_text(TINY)
    argv = ["--config", str(root / "tiny.yaml"), "--log_dir", "evalrun",
            "--data_root", str(root), "--output_root", str(root / "outputs"), "--device", "cpu"]
    cfg = load_config(argv)
    spec = BatchSpec(**dataclasses.asdict(cfg.batch_spec()), pallas_conv=True)
    xla_spec = dataclasses.replace(spec, pallas_conv=False)
    dc = ScannetDatasetConfig(meta_dir=cfg.path_scannet_meta)
    dataset = ScannetReferenceDataset(
        get_scanrefer(cfg.data_root, "val"), "val", data_root=cfg.data_root,
        num_points=cfg.num_points, use_augment=False, seed=cfg.seed, dc=dc)
    loader = PaddedLoader(dataset, spec, cfg.batch_size, shuffle=False, num_workers=1,
                          drop_last=False, voxel_size_ap=cfg.voxel_size_ap,
                          voxel_size_glp=cfg.voxel_size_glp)
    batches = list(loader)
    assert len(batches) == 2 and not batches[-1]["sample_valid"].all()

    model = JaxModel(input_feature_dim=cfg.input_feature_dim, num_classes=cfg.num_classes,
                     max_candidates=cfg.max_candidates)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(7), "dropout": jax.random.key(8)},
        batch_to_device_dict(batches[0], xla_spec))
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    stats = perturb_stats(jax.device_get(v["batch_stats"]), 9)

    @jax.jit
    def step(variables, dd):
        out = jax_eval(jax_loss(model.apply(variables, dd, train=False),
                                jnp.asarray(dc.mean_size_arr)))
        return {"ref_iou": out["ref_iou"], "ref_acc": out["ref_acc"],
                "multiple": out["ref_multiple_mask"], "others": out["ref_others_mask"],
                "lang_correct": out["lang_correct"]}

    want = {k: [] for k in ("ref_iou", "ref_acc", "multiple", "others", "lang_correct")}
    for b in batches:
        valid = b["sample_valid"]
        dd = {k: val for k, val in b.items() if k != "sample_valid"}
        res = jax.device_get(step({"params": params, "batch_stats": stats},
                                  batch_to_device_dict(dd, xla_spec)))
        for k in want:
            want[k].append(np.asarray(res[k])[valid])
    want = {k: np.concatenate(val) for k, val in want.items()}

    run = os.path.join(cfg.path_output, STAMP)
    os.makedirs(run)
    torch.save({k: torch.from_numpy(np.array(val))
                for k, val in export_state_dict(params, stats).items()},
               os.path.join(run, "model_last.pth"))
    try:
        table = eval_cli.main(argv)
        scores = dict(np.load(os.path.join(run, "scores.npz")))
        cached = eval_cli.main(argv)
    finally:
        precision.set_compute_dtype(None)
    return dict(want=want, table=table, scores=scores, cached=cached)


def test_scores_match_jax(runs):
    want, got = runs["want"], runs["scores"]
    assert set(got) == set(eval_cli.SCORE_KEYS) | {"lang_acc"}
    assert len(got["ref_iou"]) == 6 and got["pred_bboxes"].shape == (6, 8, 3)
    np.testing.assert_allclose(got["ref_iou"], want["ref_iou"], rtol=1e-4, atol=1e-5)
    for k in ("ref_acc", "multiple", "others", "lang_correct"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["lang_acc"], got["lang_correct"])
    assert got["multiple"].any() and not got["multiple"].all()


def test_acc_table_matches_jax(runs):
    want = runs["want"]
    table = jax_aggregate(want["ref_iou"], want["ref_acc"], want["multiple"], want["others"])
    assert runs["table"] == table
    assert runs["table"]["overall"]["overall"]["count"] == 6


def test_cached_run_prints_the_same_table(runs):
    assert runs["cached"] == runs["table"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_scores_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    args = (rng.uniform(0, 1, n), rng.integers(0, 2, n).astype(np.float32),
            rng.integers(0, 2, n).astype(bool), rng.integers(0, 2, n).astype(bool))
    if seed == 2:  # an empty cell
        args = args[:2] + (np.zeros(n, bool), args[3])
    assert aggregate_scores(*args) == jax_aggregate(*args)
