"""``scripts/train.py --config config/PointGroup.yaml --device cpu``: the
train CLI picks PointGroup from the config's ``model`` and trains it
through ``Config``, ``train/pointgroup.PointGroupSolver`` and the step
path, over scans written by ``data/synthetic_scans`` and exported by
``data/prepare`` (two train scenes at a batch of 1: two steps, one val
scene), with the yaml's keys and smaller capacities."""

import json
import os

import numpy as np

from instancerefer_tpu_torch.data.prepare import batch_export
from instancerefer_tpu_torch.data.synthetic_scans import write_scannet_scans
from instancerefer_tpu_torch.scripts import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_cli_trains_pointgroup(tmp_path):
    scannet = tmp_path / "data" / "scannet"
    rng = np.random.default_rng(0)
    for split, scans in (("train", ("scene0000_00", "scene0001_00")), ("val", ("scene0002_00",))):
        write_scannet_scans(str(scannet), scans, rng, split=split, num_verts=900, num_faces=600,
                            num_objects=(3, 4), num_masks=1)
        batch_export(split, str(scannet / "scans"), str(scannet / "PointGroupInst" / split),
                     str(scannet / "pointgroup_data"), str(scannet / "meta_data"), device="cpu")
    with open(os.path.join(ROOT, "config", "PointGroup.yaml")) as f:
        text = f.read()
    for key, value in (("batch_size", "1"), ("epoch", "1"),
                       ("level_caps", "[960, 960, 960, 960, 768, 512, 256]"),
                       ("point_cap", "960"), ("compute_dtype", "float32")):
        lines = [ln for ln in text.splitlines() if ln.strip().startswith(key + ":")]
        assert len(lines) == 1, key
        indent = lines[0][:len(lines[0]) - len(lines[0].lstrip())]
        text = text.replace(lines[0], f"{indent}{key}: {value}")
    cfg_path = tmp_path / "pg.yaml"
    cfg_path.write_text(text)
    solver = train_cli.main(["--config", str(cfg_path), "--log_dir", "pg", "--data_root",
                             str(tmp_path / "data"), "--output_root", str(tmp_path / "out"),
                             "--device", "cpu"])
    assert solver.steps == {"train": 2, "val": 1}
    run = solver.root
    for name in ("model_last.pth", "checkpoint.tar", "log.txt", "scalars.jsonl", "best.txt",
                 "info.json"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(os.path.join(run, "info.json")) as f:
        assert json.load(f)["model"] == "pointgroup"
    records = [json.loads(ln) for ln in open(os.path.join(run, "scalars.jsonl"))]
    assert records and all(np.isfinite(r["loss"]) for r in records)
    with open(os.path.join(run, "log.txt")) as f:
        assert "steps: eager (on cpu)" in f.read()
    # the best model is the one of the lowest val loss: the one epoch's
    assert solver.best["epoch"] == 1 and abs(solver.best["loss"] - records[-1]["loss"]) < 1e-4
    assert os.path.exists(os.path.join(run, "model.pth"))
