"""The port's caps fitter (``instancerefer_tpu_torch/scripts/fit_caps.py``)
against the JAX package's ``scripts/calibrate_bands.fit_caps``.

* On synthetic scenes and on a ``tests/fake_scanrefer`` root: the same
  distribution stats (uncapped pyramid rows per stage, candidates under the
  GT-class filter, instances), the same ``max_candidates`` and
  ``max_instances``, and caps of ``ceil(max * (1 + margin))`` rounded up to
  the kernels' 64-row tile (JAX rounds to its band chunk).
* The profile ``--emit-yaml`` writes loads through ``config.load_config``'s
  ``band_profile``.
* The eval CLI's overflow gate names this fitter, and no script of the JAX
  package (the card's machine has no JAX).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from instancerefer_tpu.data import dataset as jdataset
from instancerefer_tpu.data import synthetic as jsynthetic

from instancerefer_tpu_torch.config import load_config
from instancerefer_tpu_torch.data import dataset, synthetic
from instancerefer_tpu_torch.scripts import fit_caps

from fake_scanrefer import make_fake_root
from test_torch_host_pipeline import jax_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
SPEC = dataclasses.replace(synthetic.TEST_SPEC, scene_caps=(4096, 2048, 1024, 512, 256),
                           inst_caps=(2048, 1024, 512, 256, 128))


def _calibrate_bands():
    spec = importlib.util.spec_from_file_location(
        "calibrate_bands", os.path.join(ROOT, "scripts", "calibrate_bands.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _synthetic(mod, n=6, points=3000):
    rng = np.random.default_rng(0)
    return [mod.make_core_sample(rng, num_points=points, num_instances=6, num_candidates=4,
                                 scan_idx=i, mean_size_arr=MEAN_SIZE) for i in range(n)]


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr_caps")
    make_fake_root(root, np.random.default_rng(0))
    return str(root)


def _fake_cores(mod, root):
    ds = mod.ScannetReferenceDataset(mod.get_scanrefer(root, "train"), "train", data_root=root,
                                     num_points=500, use_augment=False)
    return [ds.get_core(i) for i in range(len(ds))]


@pytest.mark.parametrize("source", ["synthetic", "fake_root"])
@pytest.mark.parametrize("margin", [0.0, 0.1])
def test_counts_and_caps_match_jax(fake_root, source, margin):
    if source == "synthetic":
        got_cores, want_cores = _synthetic(synthetic), _synthetic(jsynthetic)
    else:
        got_cores, want_cores = _fake_cores(dataset, fake_root), _fake_cores(jdataset, fake_root)
    rec, stats = fit_caps.fit_caps(got_cores, SPEC, margin)
    jrec, jstats = _calibrate_bands().fit_caps(want_cores, jax_spec(SPEC), margin)
    assert stats == jstats
    assert stats["samples"] == len(got_cores) > 0
    for key in ("scene", "inst"):
        want = [max(-(-int(np.ceil(m * (1 + margin))) // 64) * 64, 64)
                for m in stats[f"{key}_max"]]
        assert rec[f"{key}_caps"] == want
        assert all(c % 64 == 0 and c >= m for c, m in zip(want, stats[f"{key}_max"]))
    assert rec["max_candidates"] == jrec["max_candidates"]
    assert rec["max_instances"] == jrec["max_instances"]


def test_emitted_profile_loads_through_band_profile(tmp_path):
    path = tmp_path / "profile.yaml"
    fitted = fit_caps.main(["--config", os.path.join(ROOT, "config", "InstanceRefer.yaml"),
                            "--synthetic", "--batches", "1", "--batch_size", "4",
                            "--points", "3000", "--fit-caps", "--emit-yaml", str(path)])
    config = tmp_path / "run.yaml"
    config.write_text(f"TRAIN:\n  batch_size: 4\nTPU:\n  band_profile: {path}\n")
    cfg = load_config(["--config", str(config)])
    assert cfg.scene_caps == tuple(fitted["scene_caps"])
    assert cfg.inst_caps == tuple(fitted["inst_caps"])
    assert (cfg.max_candidates, cfg.max_instances) == (fitted["max_candidates"],
                                                       fitted["max_instances"])
    assert cfg.batch_spec().scene_caps == tuple(fitted["scene_caps"])


def test_eval_overflow_gate_names_the_ports_fitter():
    """The card's machine has no JAX: the gate must not send the user to a
    script of the JAX package."""
    from instancerefer_tpu_torch.scripts.eval import check_eval_overflow

    with pytest.raises(SystemExit) as err:
        check_eval_overflow({"scene": 0.1, "inst": 0.0, "cand": 0.0}, allow=False)
    msg = str(err.value)
    assert "python -m instancerefer_tpu_torch.scripts.fit_caps" in msg
    assert "calibrate_bands" not in msg and "scripts/" not in msg
    assert "instancerefer_tpu." not in msg and "instancerefer_tpu/" not in msg
