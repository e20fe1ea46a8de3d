"""The port runs where there is no jax, flax, yaml, orbax or optax and no
JAX package (an eval forward, one train step, the train and eval CLIs, the
three multiview scripts, the caps fitter and a 2-rank data-parallel step
over gloo), and ``chip_smoke.py`` refuses to run without a GPU.

The GPU machine has PyTorch but none of jax, flax, yaml, orbax or optax, so
the port — host pipeline included — must not import them, even indirectly;
and it imports nothing of ``instancerefer_tpu``, not even its numpy modules.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fake_scanrefer import make_fake_root
from test_torch_multiview_scripts import SCENES, write_fake_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "instancerefer_tpu_torch")
BANNED = {"jax", "flax", "yaml", "orbax", "optax", "instancerefer_tpu"}

SLICE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = sys.modules["flax"] = sys.modules["yaml"] = None
sys.modules["instancerefer_tpu"] = None
import numpy as np
import torch
from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss
from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

dd = batch_to_torch(make_batch(2, TEST_SPEC, seed=0), TEST_SPEC, "cpu")
model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                      generator=torch.Generator().manual_seed(0)).eval()
ms = torch.tensor(np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]]),
                  dtype=torch.float32)
with torch.no_grad():
    out = get_eval(get_loss(model(dd), ms))
assert torch.isfinite(out["loss"]) and out["lang_scores"].shape == (2, 18)
metrics, _ = train_step(model, make_optimizer(model.parameters(), 1e-3, 1e-5), dd, ms)
assert torch.isfinite(metrics["loss"]) and model.training
assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in ("jax", "flax", "yaml", "instancerefer_tpu"))
print("ok")
"""


def test_slice_runs_without_jax_flax_yaml():
    """An eval forward and a train step where jax, flax, yaml and the JAX
    package cannot be imported."""
    res = subprocess.run([sys.executable, "-c", SLICE_WITHOUT_JAX], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_no_module_imports_jax_flax_or_yaml():
    """No module of the port, not ``chip_smoke.py`` and not the rank
    script of the data-parallel tests imports any of ``BANNED``, the JAX
    package among them."""
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_ddp_rank.py")]
    for d, _, names in os.walk(PACKAGE):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & BANNED, f"{path}:{node.lineno} imports {roots & BANNED}"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Here there is no CUDA device: nonzero exit and no ``ok`` line, from the
    repo and from a directory that holds the script alone."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd in (ROOT, str(tmp_path)):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


TINY = """
GENERAL:
  manual_seed: 123
DATA:
  num_points: 500
MODEL:
  use_gt_lang: True
TRAIN:
  batch_size: 4
  num_workers: 1
  epoch: 2
  verbose: 1
  lr_decay_step: [1]
TPU:
  compute_dtype: float32
  max_des_len: 16
  lang_bucket: 8
  max_instances: 8
  max_candidates: 4
  scene_caps: [256, 128, 64, 32, 16]
  inst_caps: [256, 128, 64, 32, 16]
"""


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m instancerefer_tpu_torch.scripts.<name> ...`` in a process
    where importing any of ``BANNED`` (the JAX package too) raises
    ImportError."""
    tmp = tmp_path_factory.mktemp("cli")
    blocked = tmp / "blocked"
    for name in BANNED:
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(
            f"raise ImportError('{name} is not installed on the card')\n")
    root = tmp / "fake"
    make_fake_root(root, np.random.default_rng(0))
    (root / "tiny.yaml").write_text(TINY)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(blocked), ROOT]))

    def run(name, *args, log_dir="clirun", config="tiny.yaml", device="cpu"):
        argv = [sys.executable, "-m", f"instancerefer_tpu_torch.scripts.{name}",
                "--config", str(root / config), "--log_dir", log_dir,
                "--data_root", str(root), "--output_root", str(root / "outputs"), *args]
        if device:
            argv += ["--device", device]
        return subprocess.run(argv, cwd=str(tmp), env=env, capture_output=True, text=True,
                              timeout=300)

    def runs(log_dir):
        return sorted(glob.glob(str(root / "outputs" / "ScanRefer" / log_dir / "checkpoints" / "*")))

    frames = write_fake_frames(str(tmp / "frames"))

    def script(name, *args, device="cpu"):
        """``python -m instancerefer_tpu_torch.scripts.<name> ...`` of a
        multiview script over the fake frames root."""
        argv = [sys.executable, "-m", f"instancerefer_tpu_torch.scripts.{name}", *args]
        if device:
            argv += ["--device", device]
        return subprocess.run(argv, cwd=str(tmp), env=env, capture_output=True, text=True,
                              timeout=300)

    return dict(run=run, runs=runs, root=root, script=script, frames=frames, env=env, tmp=tmp)


def _ok(res):
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_clis_run_without_jax(cli):
    run, root = cli["run"], cli["root"]
    out = _ok(run("train"))
    assert "start training" in out and "epoch 2 starting" in out
    (first,) = cli["runs"]("clirun")
    for name in ("model_last.pth", "model.pth", "checkpoint.tar", "log.txt", "scalars.jsonl",
                 "best.txt", "info.json"):
        assert os.path.isfile(os.path.join(first, name)), name
    tar = torch.load(os.path.join(first, "checkpoint.tar"), weights_only=True)
    assert tar["epoch"] == 2 and set(tar) == {"epoch", "model_state_dict",
                                              "optimizer_state_dict", "best"}
    last = torch.load(os.path.join(first, "model_last.pth"), weights_only=True)
    assert list(last) == list(tar["model_state_dict"])
    assert "lang.gru.weight_ih_l0_reverse" in last
    records = [json.loads(line) for line in open(os.path.join(first, "scalars.jsonl"))]
    train = [r for r in records if r["phase"] == "train"]
    assert [r["lr"] for r in train] == [1e-3, 1e-3, 1e-4, 1e-4]  # 2 steps an epoch
    assert all(np.isfinite(r["loss"]) for r in records)
    assert json.load(open(os.path.join(first, "info.json")))["num_devices"] == 1

    # the tiny caps overflow: eval refuses to score, and caches nothing
    res = run("eval")
    assert res.returncode != 0 and "capacity overflow" in res.stderr
    assert "python -m instancerefer_tpu_torch.scripts.fit_caps" in res.stderr
    assert not os.path.exists(os.path.join(first, "scores.npz"))
    cold = _ok(run("eval", "--allow_overflow"))
    scores = dict(np.load(os.path.join(first, "scores.npz")))
    assert len(scores["ref_iou"]) == 6 and "acc@0.25" in cold
    warm = _ok(run("eval"))
    assert "loading cached scores" in warm
    overall = [[line for line in o.splitlines() if line.startswith("overall:")]
               for o in (cold, warm)]
    assert overall[0] and overall[0] == overall[1]

    stamp = os.path.basename(first)
    (root / "resume.yaml").write_text(
        TINY.replace("epoch: 2", f"epoch: 3\n  use_checkpoint: {stamp}"))
    out = _ok(run("train", config="resume.yaml"))
    assert "loading checkpoint" in out
    assert "epoch 3 starting" in out and "epoch 2 starting" not in out
    assert len(cli["runs"]("clirun")) == 2

    (root / "predicted.yaml").write_text(
        TINY.replace("use_gt_lang: True", "use_gt_lang: False").replace("epoch: 2", "epoch: 1"))
    out = _ok(run("train", log_dir="predrun", config="predicted.yaml"))
    assert "epoch 1 starting" in out
    out = _ok(run("eval", "--allow_overflow", log_dir="predrun", config="predicted.yaml"))
    assert "pass 1 done: predicted classes for 6 samples" in out


MULTIVIEW = ("compute_multiview_features", "project_multiview_features",
             "project_multiview_labels")


def test_multiview_scripts_run_without_jax(cli):
    """ENet features of every frame, their projection into one HDF5 database
    and the label PLYs, with random ENet weights."""
    import h5py

    frames, script = cli["frames"], cli["script"]
    _ok(script("compute_multiview_features", "--frames", f"{frames}/frames",
               "--out", f"{frames}/feats", "--batch", "3"))
    for scene in SCENES:
        assert len(os.listdir(f"{frames}/feats/{scene}")) == 4
    common = ["--maxpool", "--scannet_data", f"{frames}/scannet_data", "--frames",
              f"{frames}/frames"]
    _ok(script("project_multiview_features", *common, "--features", f"{frames}/feats",
               "--out", f"{frames}/mv.hdf5"))
    with h5py.File(f"{frames}/mv.hdf5", "r") as db:
        assert sorted(db) == list(SCENES)
        assert all(db[s].shape == (3000, 128) and np.isfinite(db[s][:]).all() for s in SCENES)
    _ok(script("project_multiview_labels", *common, "--out", f"{frames}/plys"))
    assert sorted(os.listdir(f"{frames}/plys")) == [f"{s}.ply" for s in SCENES]


@pytest.mark.parametrize("name", ["train", "eval", *MULTIVIEW])
def test_clis_need_a_card_unless_told_cpu(cli, name):
    if name in MULTIVIEW:
        res = cli["script"](name, "--frames", f"{cli['frames']}/frames", "--out",
                            f"{cli['frames']}/nocard", device=None)
    else:
        res = cli["run"](name, log_dir="nocard", device=None)
    assert res.returncode != 0 and "--device cpu" in res.stderr


def test_fit_caps_runs_without_jax(cli, tmp_path):
    """The overflow gate's fitter, where jax cannot be imported; a config
    whose ``band_profile`` is its profile loads the fitted caps."""
    from instancerefer_tpu_torch.config import load_config

    profile = tmp_path / "caps.yaml"
    res = subprocess.run([sys.executable, "-m", "instancerefer_tpu_torch.scripts.fit_caps",
                          "--synthetic", "--fit-caps", "--emit-yaml", str(profile)],
                         cwd=str(cli["tmp"]), env=cli["env"], capture_output=True, text=True,
                         timeout=300)
    out = _ok(res)
    fitted = [line.strip().split(": ", 1) for line in out.splitlines() if line.startswith("  ")]
    assert [k for k, _ in fitted] == ["scene_caps", "inst_caps", "max_candidates",
                                      "max_instances"]
    (tmp_path / "run.yaml").write_text(f"TPU:\n  band_profile: {profile}\n")
    cfg = load_config(["--config", str(tmp_path / "run.yaml")])
    assert [str(list(cfg.scene_caps)), str(list(cfg.inst_caps)), str(cfg.max_candidates),
            str(cfg.max_instances)] == [v for _, v in fitted]


def test_two_rank_step_runs_without_jax(cli, tmp_path):
    """``tests/torch_ddp_rank.py`` on 2 gloo ranks, where jax cannot be
    imported: the ranks agree on the loss and the gradients."""
    from instancerefer_tpu_torch.data.synthetic import TEST_SPEC
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer

    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0), dropout_override=0.0)
    torch.save(model.state_dict(), tmp_path / "init.pt")
    env = dict(cli["env"], OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_ddp_rank.py"),
                               str(r), "2", str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    for case in ("full", "partial"):
        ranks = [torch.load(tmp_path / f"{case}_rank{r}.pt", weights_only=False) for r in (0, 1)]
        assert ranks[0]["wrapped"] and ranks[0]["loss"] == ranks[1]["loss"]
        assert np.isfinite(ranks[0]["loss"])
        assert all(torch.equal(g, ranks[1]["grads"][k]) for k, g in ranks[0]["grads"].items())
