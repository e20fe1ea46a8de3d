"""The port's bench (``instancerefer_tpu_torch/scripts/bench.py``) on the
CPU: its FLOP counts against ``bench.py`` and the model's own convs, its
correctness gate, its CPU rehearsal where jax, yaml and the JAX package
cannot be imported, and its refusal to run without a card.  No test here
holds a time to a limit; the times come from the card only.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from instancerefer_tpu.data import pipeline as jpipeline

import chip_smoke
from instancerefer_tpu_torch.config import band_profile_kwargs
from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.data.pipeline import BatchSpec
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.scripts import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_SPEC = BatchSpec(**band_profile_kwargs(bench.PROFILE))
BLOCKED = ("jax", "flax", "yaml", "instancerefer_tpu")
RUN_BLOCKED = (
    "import runpy, sys\n"
    + "".join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED)
    + "sys.argv = ['bench'] + sys.argv[1:]\n"
    "runpy.run_module('instancerefer_tpu_torch.scripts.bench', run_name='__main__')\n"
)
# the keys of bench.py's JSON line that the port prints under the same names
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_note", "device_scenes_s",
                 "train_scenes_s", "e2e_scenes_s_1core_host", "eval_mfu", "train_mfu",
                 "occupancy_curve", "host_phase_ms", "e2e_workers", "e2e_median_of",
                 "native_voxelizer", "nproc", "git_sha"}


def _bench_py():
    """``bench.py``, loaded by file path as it loads its own helper."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_spec_is_the_fitted_profile():
    assert BENCH_SPEC.scene_caps == (18176, 4352, 1280, 512, 256)
    assert BENCH_SPEC.inst_caps == (1792, 1792, 1280, 512, 256)
    assert (BENCH_SPEC.max_candidates, BENCH_SPEC.max_instances) == (8, 24)
    assert (BENCH_SPEC.max_tokens, BENCH_SPEC.lang_bucket, BENCH_SPEC.feat_dim) == (126, 0, 7)


@pytest.mark.parametrize("which", ["test", "bench"])
@pytest.mark.parametrize("batch_size", [2, 32, 64])
def test_padded_count_equals_bench_py(which, batch_size):
    spec = {"test": TEST_SPEC, "bench": BENCH_SPEC}[which]
    jspec = jpipeline.BatchSpec(**dataclasses.asdict(spec), pallas_conv=True)
    assert bench.model_flops_padded(spec, batch_size) == \
        _bench_py().model_flops_per_batch(jspec, batch_size)


def _batch():
    return make_batch(2, TEST_SPEC, seed=0, mean_size_arr=bench.MEAN_SIZE, **bench.CPU_SCENE_KW)


def test_valid_entries_are_a_direct_count_of_the_maps():
    batch = _batch()
    entries = bench.conv_entries(batch, TEST_SPEC)
    assert len(entries) == 18 and sum(n for *_, n in entries) == 26
    for key, got, *_ in entries:
        nbr = batch[key]
        want = sum(1 for row in nbr.tolist() for i in row if i >= 0)
        assert got == want > 0, key


def test_valid_count_follows_the_model_convs():
    """The FLOPs of the valid entries equal those of the maps and widths
    the model's 26 convs are called with in an eval forward."""
    batch = _batch()
    dd = batch_to_torch(batch, TEST_SPEC, "cpu")
    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0)).eval()
    with chip_smoke.record_launches() as calls, torch.no_grad():
        model(dd)
    assert len(calls) == 26
    want = sum(2 * int((c["nbr"] >= 0).sum()) * c["cin"] * c["cout"] for c in calls)
    assert bench.model_flops_valid(batch, TEST_SPEC) - bench.dense_flops(TEST_SPEC, 2) == want


def _train_state():
    grads = {"a.w": torch.tensor([3.0, 4.0]), "a.b": torch.tensor([0.5]), "c.w": torch.ones(3)}
    return {"loss": 2.0, "grads": grads, "stats": {"bn.running_mean": torch.tensor([1.0, -2.0])},
            "params": {n: torch.full_like(g, 0.1) for n, g in grads.items()}}


def test_gate_fails_on_a_disagreement():
    lr = 1e-3
    want = _train_state()
    assert bench.compare("train", _train_state(), want, lr)["ok"]
    assert bench.compare("train", dict(_train_state(), loss=2.0 * (1 + 5e-5)), want, lr)["ok"]
    assert not bench.compare("train", dict(_train_state(), loss=2.0 * (1 + 2e-4)), want, lr)["ok"]
    out = {k: torch.ones(2, 3) for k in bench.EVAL_KEYS}
    out["ref_acc"] = torch.tensor([True, False])
    assert bench.compare("eval", out, dict(out), lr)["ok"]
    flipped = dict(out, ref_acc=torch.tensor([True, True]))
    assert not bench.compare("eval", out, flipped, lr)["ok"]
    moved = dict(out, scene_scores=out["scene_scores"] + 2e-3)
    assert not bench.compare("eval", out, moved, lr)["ok"]


def _moved(kind):
    got = _train_state()
    if kind == "a layer's gradient":  # 6% of the layer's norm, 1.2% overall
        got["grads"]["a.b"] = got["grads"]["a.b"] + 0.3
    elif kind == "every gradient":  # 3% overall, under 5% in each layer
        got["grads"] = {n: g * 1.03 for n, g in got["grads"].items()}
    elif kind == "a running statistic":
        got["stats"]["bn.running_mean"] = torch.tensor([1.0, -2.01])
    elif kind == "one parameter":  # one element 3 lr away
        got["params"]["c.w"] = got["params"]["c.w"] + torch.tensor([3e-3, 0.0, 0.0])
    elif kind == "every parameter":  # every element 0.3 lr away on average
        got["params"] = {n: p + 3e-4 for n, p in got["params"].items()}
    elif kind == "no gradient":
        got["grads"] = {n: torch.zeros_like(g) for n, g in got["grads"].items()}
        return got, dict(_train_state(), grads=got["grads"])
    return got, _train_state()


@pytest.mark.parametrize("kind", ["a layer's gradient", "every gradient", "a running statistic",
                                  "one parameter", "every parameter", "no gradient"])
def test_train_gate_holds_the_whole_step(kind):
    """The first train replay is held to the eager step in its gradients,
    running statistics and parameters after Adam, not only its loss."""
    got, want = _moved(kind)
    res = bench.compare("train", got, want, 1e-3)
    assert res["loss_rel_diff"] == 0 and not res["ok"], res


@pytest.mark.parametrize("wrong", [None, "gather_conv", "down_dx", "subm_conv_bwd", "conv_dw"])
def test_twin_check_catches_a_wrong_kernel(wrong, monkeypatch):
    """``held_against_twins`` over an eager train step at TEST_SPEC: every
    wrapper is called as often as a step launches it and agrees with its
    twin; a wrapper whose output is off by 2% of its largest value fails."""
    from instancerefer_tpu_torch.models import basic_blocks
    from instancerefer_tpu_torch.ops import sparse_conv
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    if wrong is not None:
        real = getattr(sparse_conv, wrong)

        def off(*args, **kw):
            out = real(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            bumped = first + 0.02 * first.float().abs().max().to(first.dtype)
            return (bumped,) + out[1:] if isinstance(out, tuple) else bumped

        for module in (sparse_conv, basic_blocks):
            if hasattr(module, wrong):
                monkeypatch.setattr(module, wrong, off)
    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0))
    report = {}
    with bench.held_against_twins(report):
        train_step(model, make_optimizer(model.parameters(), 1e-3, 1e-5), dd,
                   torch.tensor(bench.MEAN_SIZE, dtype=torch.float32))
    assert {k: e["calls"] for k, e in report.items()} == {"K1": 34, "K2": 16, "K3": 10}
    assert bench.twins_ok(report, "train") == (wrong is None), report
    assert getattr(sparse_conv, "gather_conv").__module__ != bench.__name__


def test_the_copy_steps_like_the_model():
    """The bench's copy takes the model and its optimizer together: one
    eager train step of each from one state gives the same state."""
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    ms = torch.tensor(bench.MEAN_SIZE, dtype=torch.float32)
    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 1e-3, 1e-5)
    train_step(model, opt, dd, ms)  # Adam holds moments now
    twin, twin_opt = bench.copy.deepcopy((model, opt))
    assert twin_opt.param_groups[0]["params"][0] is next(twin.parameters())
    states = []
    for m, o in ((twin, twin_opt), (model, opt)):
        torch.manual_seed(0)
        states.append(bench.step_state("train", train_step(m, o, dd, ms), m))
    assert bench.compare("train", states[1], states[0], 1e-3)["ok"]
    assert bench.compare("train", states[1], states[0], 1e-3)["param_mean_diff_lr"] == 0


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cpu_rehearsal_without_jax(mode):
    """The bench at TEST_SPEC, B = 2, 2 replays, where jax, yaml and the
    JAX package cannot be imported: its JSON, the platform cpu, every
    time-derived value null (and none on stderr), the gate true."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN_BLOCKED, "--mode", mode, "--batch", "2", "--iters", "2",
         "--fed-iters", "2", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not re.search(r"\d (ms|s)\b|scenes/s", proc.stderr), proc.stderr
    assert BENCH_PY_KEYS <= set(r)
    assert r["device"]["platform"] == "cpu" and r["mode"] == mode and r["batch"] == 2
    assert r["metric"] == f"{mode}_scenes_per_sec" and r["correct"] is True
    for key in ("value", "vs_baseline", "device_scenes_s", "train_scenes_s",
                f"fed_{mode}_scenes_s", "e2e_scenes_s_1core_host", "eval_mfu", "train_mfu",
                "profile", "peak_memory_mib"):
        assert r[key] is None, key
    assert r["step_ms"] == {"median": None, "p90": None, "n": 2}
    assert set(r["host_phase_ms"]) >= {"pad_sample_total_ms", "collate_ms"}
    assert all(v is None for v in r["host_phase_ms"].values())
    assert r["host_probe"] == {"before": None, "after": None}
    fed = r["fed"]
    assert fed["iterations"] == 2 and fed["split"] == ("train" if mode == "train" else "val")
    assert all(fed[k] is None for k in ("scenes_s", "fetch_load_ms", "fetch_copy_ms",
                                        "fetch_stage_ms", "step_ms", "loader_only_scenes_s"))
    assert fed["cpu_count"] == os.cpu_count()
    checks = r["checks"]
    assert checks["replay_vs_eager"]["ok"] and checks["finite"] and checks["overflow_max"] == 0
    assert checks["kernels_vs_twins_ok"] and checks["fed_overflow_gated"] == (mode == "eval")
    assert {k: e["calls"] for k, e in checks["kernels_vs_twins"].items()} == (
        {"K1": 34, "K2": 16, "K3": 10} if mode == "train" else {"K1": 26})
    assert checks["launches_per_step"] == checks["launches_expected"] == dict.fromkeys(
        bench.COUNTER_NAMES, 0)
    assert 0 < r["model_gflop_valid"] < r["model_gflop_padded"]
    curve = r["occupancy_curve"]
    if mode == "eval":
        assert [c["points"] for c in curve] == [p for p, _ in bench.CPU_OCCUPANCY]
        assert all(c["eval_scenes_s"] is None and 0 < c["live_voxel_frac"] <= 1 for c in curve)
        assert r["step_gflop_valid"] == r["model_gflop_valid"]
    else:
        assert curve == [] and r["step_gflop_valid"] == pytest.approx(3 * r["model_gflop_valid"])


def test_without_a_card_the_bench_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "instancerefer_tpu_torch.scripts.bench",
                           "--mode", "eval", "--batch", "2"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
