"""The port's ``Solver`` (``instancerefer_tpu_torch/train/solver.py``)
against the JAX package's, on the same batches and the same weights.

Both solvers run 2 epochs of 2 train steps on ``TEST_SPEC`` batches of 8
(the second padded: 7 valid samples), each followed by validation, with an
lr milestone after epoch 0 and a BN-momentum schedule (0.5, then 0.25).
At 4 samples a batch the train-mode losses are ill-conditioned (the head
BatchNorms normalize over 4 rows): after two steps the seg loss moved 1.2%
between the two sides while the val loss, on running statistics, agreed to
3e-4.  At 8 they agree to 3e-4 throughout.
Dropout is 0 on both sides (flax and torch draw from other streams); weight
decay 1e-2, well above the reference's, so its fold into the gradient shows.

* Per-iteration losses of ``scalars.jsonl``: rtol 2e-3 / atol 2e-3, the
  free-running tolerance of ``tests/test_torch_train.py`` (each step starts
  from weights that rounding has moved apart).
* The val iou rates and the best epoch are equal; the lr of every train
  record equals the lr JAX's optimizer applies at that step (read from its
  update of a probe parameter).
* A port run resumed from its ``checkpoint.tar`` after epoch 1 equals the
  uninterrupted run bit for bit on the CPU.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from instancerefer_tpu.data import pipeline, synthetic
from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.train import solver as jax_solver

from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train import solver
from instancerefer_tpu_torch.utils.convert import state_dict_from_jax

SPEC = TEST_SPEC
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
HP = dict(lr=1e-3, wd=1e-2, lr_decay_step=[1], lr_decay_rate=0.1, bn_decay_step=1,
          bn_decay_rate=0.5)
B = 8
EPOCHS, STEPS = 2, 2
LOSSES = ("loss", "ref_loss", "lang_loss", "seg_loss")


def padded_batch():
    rng = np.random.default_rng(5)
    samples = [pipeline.pad_sample(synthetic.make_core_sample(
        rng, num_instances=6, num_candidates=3, scan_idx=i, mean_size_arr=MEAN_SIZE), SPEC)
        for i in range(B - 1)]
    return pipeline.finalize_batch(samples, B, SPEC)


def full_batch(seed):
    batch = make_batch(B, SPEC, seed=seed, mean_size_arr=MEAN_SIZE)
    batch["sample_valid"] = np.ones(B, bool)  # one batch structure: one JAX compile
    return batch


def batches():
    return {"train": [full_batch(21), padded_batch()], "val": [full_batch(22)]}


def _records(root):
    with open(os.path.join(root, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _port_solver(sd, out_dir, stamp):
    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          dropout_override=0.0)
    model.load_state_dict(sd)
    return solver.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp=stamp, output_dir=str(out_dir), **HP)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("solvers")
    data = batches()
    jdata = {k: [batch_to_device_dict(b, SPEC) for b in v] for k, v in data.items()}
    jmodel = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                      max_candidates=SPEC.max_candidates, dropout_override=0.0)
    js = jax_solver.Solver(jmodel, MEAN_SIZE, steps_per_epoch=STEPS, stamp="jax",
                           output_dir=str(out), use_mesh=False, seed=3, **HP)
    js.init_params(jdata["train"][0])
    sd0 = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(js.state["params"])),
                              jax.tree.map(np.asarray, jax.device_get(js.state["batch_stats"])))
    js(jdata, EPOCHS, verbose=1)

    port = _port_solver(sd0, out, "port")
    port(data, EPOCHS, verbose=1)

    first = _port_solver(sd0, out, "port_first_epoch")
    first(data, 1, verbose=1)
    resumed = _port_solver(sd0, out, "port_resumed")
    resumed.load_checkpoint(os.path.join(first.root, "checkpoint.tar"), with_opt=True)
    resumed(data, EPOCHS, verbose=1)
    return dict(jax=js, port=port, first=first, resumed=resumed)


def test_per_iteration_losses_match_jax(runs):
    want, got = _records(runs["jax"].root), _records(runs["port"].root)
    assert [(r["phase"], r["iter"]) for r in got] == [(r["phase"], r["iter"]) for r in want]
    assert [r["phase"] for r in got] == ["train", "train", "val"] * EPOCHS
    for g, w in zip(got, want):
        for k in LOSSES:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-3,
                                       err_msg=f"{g['phase']} iter {g['iter']} {k}")
    assert abs(got[0]["loss"] - got[-2]["loss"]) > 1e-3  # the run moves


def test_val_iou_rates_and_best_epoch_match_jax(runs):
    want = [r for r in _records(runs["jax"].root) if r["phase"] == "val"]
    got = [r for r in _records(runs["port"].root) if r["phase"] == "val"]
    for g, w in zip(got, want):
        assert g["iou_rate_0.25"] == w["iou_rate_0.25"]
        assert g["iou_rate_0.5"] == w["iou_rate_0.5"]
    assert runs["port"].best["epoch"] == runs["jax"].best["epoch"] >= 1
    for k in ("iou_rate_0.25", "iou_rate_0.5"):
        assert runs["port"].best[k] == runs["jax"].best[k]
    best = open(os.path.join(runs["port"].root, "best.txt")).read()
    assert f"[best] epoch: {runs['port'].best['epoch']}" in best


def test_lr_per_step_matches_jax(runs):
    """JAX's lr at step s, read off Adam's update of a probe parameter under a
    constant unit gradient (|update| = lr / (1 + eps)) through the solver's
    own optimizer.  Adam's bias corrections are rounded in float32, so the
    probe reads the lr to ~1e-5; the schedule's steps are factors of 10."""
    tx = runs["jax"].tx
    params = {"w": jax.numpy.zeros(())}
    state = tx.init(params)
    want = []
    for _ in range(EPOCHS * STEPS):
        upd, state = tx.update({"w": jax.numpy.ones(())}, state, params)
        want.append(-float(upd["w"]) * (1 + 1e-8))
    got = [r["lr"] for r in _records(runs["port"].root) if r["phase"] == "train"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got == [1e-3, 1e-3, 1e-4, 1e-4]


def test_resumed_run_equals_the_uninterrupted_one(runs):
    full, resumed = runs["port"], runs["resumed"]
    assert resumed.epochs_done == full.epochs_done == EPOCHS
    assert resumed.steps["train"] == STEPS and runs["first"].steps["train"] == STEPS
    for (n, a), (m, b) in zip(full.model.state_dict().items(), resumed.model.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    for r in (_records(full.root)[-3:], _records(resumed.root)):
        assert [x["iter"] for x in r] == [2, 3, 4]
    assert _records(full.root)[-3:] == _records(resumed.root)
    log = open(os.path.join(resumed.root, "log.txt")).read()
    assert "epoch 2 starting" in log and "epoch 1 starting" not in log
    assert resumed.best == full.best


def test_iter_report_splits_the_fetch(runs):
    """After each iter report, the fetch's wait for a staged batch
    (``fetch_load``) and the consumer's time in ``finish`` (``fetch_copy``):
    together at most the fetch (each rounded to 1e-5 s); and the producer
    thread's time staging the batch (``fetch_stage``), which overlaps the
    steps, so it is no part of the fetch.  Every iteration finishes a batch
    and every batch was staged, so both take time in every report."""
    text = open(os.path.join(runs["port"].root, "log.txt")).read()
    got = {k: np.array([float(v) for v in re.findall(rf"\[info\] mean_{k}_time: (\S+)s", text)])
           for k in ("fetch", "fetch_load", "fetch_copy", "fetch_stage")}
    for v in got.values():
        assert v.shape == (EPOCHS * STEPS,) and (v >= 0).all()
    assert (got["fetch_load"] + got["fetch_copy"] <= got["fetch"] + 2e-5).all()
    assert (got["fetch_copy"] > 0).all() and (got["fetch_stage"] > 0).all()
    assert text.index("mean_fetch_copy_time") < text.index("mean_fetch_stage_time")


def test_checkpoint_roles_and_layout(runs):
    root = runs["port"].root
    for name in ("model_last.pth", "model.pth", "checkpoint.tar", "log.txt", "scalars.jsonl",
                 "best.txt"):
        assert os.path.isfile(os.path.join(root, name)), name
    tar = torch.load(os.path.join(root, "checkpoint.tar"), weights_only=True)
    assert set(tar) == {"epoch", "model_state_dict", "optimizer_state_dict", "best"}
    assert tar["epoch"] == EPOCHS
    last = torch.load(os.path.join(root, "model_last.pth"), weights_only=True)
    assert list(last) == list(tar["model_state_dict"])
    names = [n for n, _ in runs["port"].model.named_parameters()]
    assert len(tar["optimizer_state_dict"]["state"]) == len(names)
    assert tar["optimizer_state_dict"]["param_groups"][0]["lr"] == pytest.approx(1e-4)


def test_pretrained_modules_copy_what_the_file_holds(runs, tmp_path):
    """``use_pretrained``: a run's ``model_last.pth`` warm-starts a fresh
    model to that run's weights exactly; a file without the scene module
    leaves the scene module as it was."""
    trained = runs["port"].model.state_dict()
    last = torch.load(os.path.join(runs["port"].root, "model_last.pth"), weights_only=True)
    partial = tmp_path / "no_scene.pth"
    torch.save({k: v for k, v in last.items() if not k.startswith("scene.")}, partial)
    for path, kept in ((os.path.join(runs["port"].root, "model_last.pth"), ()),
                       (str(partial), ("scene",))):
        model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                              generator=torch.Generator().manual_seed(7))
        fresh = {k: v.clone() for k, v in model.state_dict().items()}
        s = solver.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp="warm", output_dir=str(tmp_path))
        s.load_pretrained_modules(path)
        for k, v in s.model.state_dict().items():
            want = fresh[k] if k.split(".", 1)[0] in kept else trained[k]
            assert torch.equal(v, want), k


@pytest.mark.parametrize("modules", [("lang",), ("attribute", "scene")])
def test_pretrained_modules_subset_leaves_the_others(runs, tmp_path, modules):
    """``modules`` names the submodules copied, as the JAX solver's
    argument does; every other submodule keeps its own weights."""
    trained = runs["port"].model.state_dict()
    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(7))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    s = solver.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp="subset", output_dir=str(tmp_path))
    s.load_pretrained_modules(os.path.join(runs["port"].root, "model_last.pth"), modules=modules)
    for k, v in s.model.state_dict().items():
        copied = k.split(".", 1)[0] in modules
        assert torch.equal(v, trained[k] if copied else fresh[k]), k
    assert any(not torch.equal(fresh[k], trained[k]) for k in fresh if k.split(".", 1)[0] in modules)


def test_interrupt_saves_a_checkpoint(tmp_path):
    """Ctrl-C inside an epoch ends the run through the finish path: the best
    report and ``checkpoint.tar`` at the last completed epoch.  The loader
    runs on the prefetcher's thread, and what it raises is raised in the
    consumer at its batch: after the epoch's two steps, before the epoch
    ends."""
    data = batches()

    def interrupted():
        yield from data["train"]
        raise KeyboardInterrupt

    class Loader:
        def __len__(self):
            return 2

        def __iter__(self):
            return interrupted()

    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0), dropout_override=0.0)
    s = solver.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp="irq", output_dir=str(tmp_path), **HP)
    s({"train": Loader(), "val": data["val"]}, EPOCHS, verbose=1)
    tar = torch.load(os.path.join(s.root, "checkpoint.tar"), weights_only=True)
    assert tar["epoch"] == 0 and s.steps["train"] == 2
    assert os.path.isfile(os.path.join(s.root, "best.txt"))


def test_profile_steps_writes_a_trace(tmp_path):
    data = batches()
    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0))
    s = solver.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp="prof", output_dir=str(tmp_path))
    path = s.profile_steps(data["train"] + data["val"], str(tmp_path / "trace"), num_steps=2)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
