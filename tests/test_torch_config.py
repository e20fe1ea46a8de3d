"""The port's config (``instancerefer_tpu_torch/config.py``) against the JAX
package's: the YAML subset reader against ``yaml.safe_load`` on every config
of the repo and the tests' configs, ``load_config`` field by field with and
without ``band_profile``, and ``batch_spec``.  JAX and PyYAML are imported
here only, never by the port."""

import dataclasses
import glob
import os

import pytest
import yaml

from instancerefer_tpu.config import Config as JaxConfig
from instancerefer_tpu.config import load_config as jax_load_config

from instancerefer_tpu_torch import config as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*.yaml")))

# the configs the tests write (tests/test_cli_e2e.py, tests/test_band_profile.py)
TEST_YAMLS = {
    "cli_e2e": """
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
  val_step: 1000
TPU:
  # the e2e caps are deliberately tiny (glue coverage, not metric parity) —
  # opt out of the eval-time capacity-overflow gate they would trip
  allow_overflow: True
  compute_dtype: float32
  pallas_conv: False
  max_des_len: 16
  lang_bucket: 8
  max_instances: 8
  max_candidates: 4
  scene_caps: [256, 128, 64, 32, 16]
  inst_caps: [256, 128, 64, 32, 16]
""",
    "band_profile_main": "TPU:\n  band_profile: profile.yaml\n  pallas_subwin: [128,128,128,128,128]\n",
    "resume": "TRAIN:\n  epoch: 3\n  use_checkpoint: 2026-01-01_00-00-00_E2ERUN\n",
    "empty_section": "GENERAL:\n# nothing here\nDATA:\n  num_scenes: -1\n  lr: 1.\n",
    "nulls_and_paths": ("A:\n  x: ~\n  y: null\n  z:\n  p: ./a/b.yaml\n  q: /abs/x\n"
                        "  r: TRUE\n  s: [ ]\n  t: 1.5e-05\n"),
}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load_on_repo_configs(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert port.read_yaml(path) == want


@pytest.mark.parametrize("name", sorted(TEST_YAMLS))
def test_reader_equals_safe_load_on_test_configs(name):
    text = TEST_YAMLS[name]
    got = port.parse_yaml(text)
    assert got == yaml.safe_load(text)
    assert all(type(a) is type(b) for a, b in zip(_leaves(got), _leaves(yaml.safe_load(text))))


def _leaves(tree):
    for section in tree.values():
        for v in (section or {}).values():
            yield from (v if isinstance(v, list) else [v])


@pytest.mark.parametrize("text", [
    "A:\n  k: yes\n",                # YAML 1.1 boolean
    "A:\n  k: 1e-4\n",               # a string to PyYAML, a float to a reader
    "A:\n  k: 010\n",                # octal to PyYAML
    "A:\n  k: 2026-01-01\n",         # a date to PyYAML
    "A:\n  k: 'quoted'\n",
    "A:\n  k: two words\n",
    "A:\n  k: [1, [2]]\n",
    "A:\n  k: {a: 1}\n",
    "A:\n  - item\n",
    "A:\n  k:\n    nested: 1\n",
    "A:\n  k: 1\n   j: 2\n",
    "k: 1\n",                        # a value outside any section
    "A:\n\tk: 1\n",
    "A:\n  k: 1\n  k: 2\n",
    "---\nA:\n  k: 1\n",
    "A:\n  k: .inf\n",
])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        port.parse_yaml(text)


def _write_test_configs(tmp_path):
    """config/InstanceRefer.yaml as is, and with band_profile set to the
    shipped profile."""
    base = os.path.join(ROOT, "config", "InstanceRefer.yaml")
    with_profile = tmp_path / "with_profile.yaml"
    with_profile.write_text(
        open(base).read() + "  band_profile: "
        + os.path.join(ROOT, "config", "band_profile.synthetic.yaml") + "\n")
    return {"plain": base, "band_profile": str(with_profile)}


@pytest.mark.parametrize("which", ["plain", "band_profile"])
def test_load_config_agrees_with_jax(tmp_path, which):
    path = _write_test_configs(tmp_path)[which]
    argv = ["--config", path, "--log_dir", "x", "--data_root", "/d", "--output_root", "/o",
            "--pretrain", "p.pth", "--gpu", "1", "--allow_overflow"]
    want = jax_load_config(argv)
    got = port.load_config(argv + ["--device", "cpu"])
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(port.Config)}
    assert port_fields - jax_fields == {"device"} | set(port.POINTGROUP_KEYS)
    assert jax_fields - port_fields == set(port.IGNORED_KEYS)
    for name in sorted(port_fields - {"device"} - set(port.POINTGROUP_KEYS)):
        assert getattr(got, name) == getattr(want, name), name
    assert got.device == "cpu" and got.input_feature_dim == want.input_feature_dim
    assert got.exp_path == want.exp_path and got.path_output == want.path_output
    if which == "band_profile":
        assert tuple(got.scene_caps) == (18176, 4352, 1280, 512, 256)
        assert got.max_candidates == 8 and got.max_instances == 24


@pytest.mark.parametrize("which", ["plain", "band_profile"])
def test_batch_spec_agrees_with_jax(tmp_path, which):
    """Equal on every field the port's spec has; it has no band geometry,
    no ``pallas_conv`` switch (its rows are always in raster order) and no
    ``data_shards``."""
    path = _write_test_configs(tmp_path)[which]
    want = dataclasses.asdict(jax_load_config(["--config", path]).batch_spec())
    got = dataclasses.asdict(port.load_config(["--config", path]).batch_spec())
    assert not {k for k in got if k.startswith("pallas_") or k == "data_shards"}
    assert got == {k: want[k] for k in got}


def test_band_profile_overrides_warn_and_geometry_is_ignored(tmp_path):
    prof = tmp_path / "profile.yaml"
    prof.write_text("TPU:\n  pallas_subwin: [128, 128, 128, 128, 128]\n"
                    "  pallas_conv: False\n  max_candidates: 6\n")
    main = tmp_path / "main.yaml"
    main.write_text("TPU:\n  band_profile: profile.yaml\n  max_candidates: 4\n")
    with pytest.warns(UserWarning, match="max_candidates"):
        cfg = port.load_config(["--config", str(main)])
    assert cfg.max_candidates == 6
    assert not hasattr(cfg, "pallas_subwin") and not hasattr(cfg, "pallas_conv")
    main.write_text("TPU:\n  band_profile: missing.yaml\n")
    with pytest.raises(FileNotFoundError):
        port.load_config(["--config", str(main)])


def test_device_is_explicit(monkeypatch):
    cfg = port.load_config(["--config", "none.yaml"])
    assert cfg.device == "cuda"
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cfg.torch_device()
    assert port.load_config(["--device", "cpu"]).torch_device().type == "cpu"
    with pytest.raises(SystemExit):
        port.load_config(["--device", "tpu"])
