"""The port's whole eval slice — forward, ``get_loss``, ``get_eval`` —
against the JAX package on the same numpy batches and the same weights.

Batches: one built to cover every per-sample rule (3 candidates, 1, 0, and
4 candidates whose best IoU is below 0.2, so the ref loss skips it — as
``tests/test_golden_model.py`` builds them) and one plain ``make_batch``.
Tolerance: f32 on both sides, sums in other orders through two sparse
encoders — rtol 1e-4 / atol 1e-5 on scores and losses; labels, masks and
accuracies exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data import pipeline, synthetic
from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.train.evaluate import get_eval as jax_eval
from instancerefer_tpu.train.losses import get_loss as jax_loss

from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss

from jax_weights import state_dict_from_jax

SPEC = TEST_SPEC
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
TARGET = 5
CLOSE = ("lang_scores", "lang_feat", "attribute_scores", "obj_feats", "relation_scores",
         "scene_scores", "seg_scores", "vis_atten", "loss", "ref_loss", "lang_loss",
         "seg_loss", "ref_iou", "ref_gt_obb", "pred_bboxes")
EXACT = ("score_mask", "num_filtered_objs", "cluster_label", "cluster_label_mask",
         "ref_acc", "lang_acc", "seg_acc", "ref_iou_rate_0.25", "ref_iou_rate_0.5",
         "num_missed", "scene_region_label")


def rules_batch():
    rng = np.random.default_rng(11)
    plans = [
        [TARGET, TARGET, TARGET, 1, 2, 3],  # 3 candidates
        [TARGET, 0, 1, 2, 3, 4],  # 1 candidate: selected, not scored
        [0, 1, 2, 3, 4, 6],  # 0 candidates: a miss
        [TARGET, TARGET, TARGET, TARGET, 2, 3],  # 4 candidates, IoU skip below
    ]
    cores = []
    for i, plan in enumerate(plans):
        core = synthetic.make_core_sample(
            rng, num_points=1500, num_instances=6, points_per_instance=256,
            target_class=TARGET, num_candidates=0, scan_idx=i, mean_size_arr=MEAN_SIZE,
        )
        core.instance_class = list(plan)
        cores.append(core)
    cores[3].ref_center_label = cores[3].ref_center_label + 50.0  # max IoU < 0.2
    return pipeline.collate([pipeline.pad_sample(c, SPEC) for c in cores], SPEC)


BATCHES = {
    "rules": rules_batch,
    "synthetic": lambda: make_batch(4, SPEC, seed=2, mean_size_arr=MEAN_SIZE),
}


@pytest.fixture(scope="module")
def models():
    model = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                     max_candidates=SPEC.max_candidates)
    jdd = batch_to_device_dict(BATCHES["rules"](), SPEC)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jdd
    )
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    rng = np.random.default_rng(9)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(0, 0.02, a.shape) if p[-1].key == "mean"
                      else np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        jax.device_get(v["batch_stats"]),
    )

    @jax.jit
    def run(variables, dd):
        out = model.apply(variables, dd, train=False)
        out = jax_eval(jax_loss(out, jnp.asarray(MEAN_SIZE)))
        return {k: out[k] for k in CLOSE + EXACT}

    port = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates).eval()
    port.load_state_dict(state_dict_from_jax(params, stats))
    return functools.partial(run, {"params": params, "batch_stats": stats}), port


@pytest.fixture(scope="module", params=sorted(BATCHES))
def outputs(request, models):
    jax_run, port = models
    batch = BATCHES[request.param]()
    want = jax.tree.map(np.asarray, jax_run(batch_to_device_dict(batch, SPEC)))
    with torch.no_grad():
        got = get_eval(get_loss(port(batch_to_torch(batch, SPEC, "cpu")),
                                torch.tensor(MEAN_SIZE, dtype=torch.float32)))
    return request.param, want, {k: got[k].numpy() for k in CLOSE + EXACT}


def test_batches_cover_the_candidate_rules(outputs):
    name, want, _ = outputs
    counts = want["num_filtered_objs"]
    if name == "rules":
        assert counts.tolist() == [3, 1, 0, 4]
        assert want["num_missed"] == 1
    else:
        assert (counts >= 2).all() and want["score_mask"].any()


def test_scores_and_features_match(outputs):
    _, want, got = outputs
    cand = want["score_mask"]
    for k in ("lang_scores", "lang_feat", "seg_scores", "vis_atten"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("attribute_scores", "relation_scores", "scene_scores", "obj_feats"):
        np.testing.assert_allclose(got[k][cand], want[k][cand], rtol=1e-4, atol=1e-5, err_msg=k)


def test_losses_match(outputs):
    _, want, got = outputs
    for k in ("loss", "ref_loss", "lang_loss", "seg_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_matches(outputs):
    _, want, got = outputs
    for k in ("ref_iou", "ref_gt_obb", "pred_bboxes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
