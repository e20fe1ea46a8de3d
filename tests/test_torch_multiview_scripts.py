"""The port's three multiview scripts (``instancerefer_tpu_torch/scripts/
{compute_multiview_features,project_multiview_features,
project_multiview_labels}.py``) with ``--device cpu`` against the JAX
package's (``scripts/*.py``), on a fake frames root.

The root (``write_fake_frames``): two synthetic rooms of surface points
(``{scene}_vert.npy``), four float32 poses each (``pose/*.txt``), the
z-buffered depth frames of those poses as 16-bit millimetre PNGs at 32 x 41
(``depth/*.png``) and 240 x 320 color JPEGs (``color/*.jpg``, resized and
cropped to 256 x 328 by both scripts' ``resize_crop_image``).  Both sides
get one random ENet state dict: the port as a ``.pth``, JAX as an orbax
checkpoint of ``scripts/convert_enet.convert_state_dict`` of it.  Its
classifier rows are made orthogonal to the mean feature of a frame, so that
the labels vary over a frame (random weights alone give one class
everywhere).

* Features: the per-frame npys within 1e-4 max abs (the limit of
  ``tests/test_enet_convert.py``: f32 convolutions summed in other orders).
* Projection: both scripts project the same feature npys (the JAX
  script's); the HDF5 databases hold the same scenes and agree to 1e-5, for
  ``--maxpool`` and first-hit.
* Labels: the PLYs of both scripts, majority vote and first-hit: the same
  header and vertices, and the same colors on all but a few points (an
  argmax whose top two logits lie within the frameworks' rounding of each
  other may pick the other class; at most 0.1% of points).
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from instancerefer_tpu_torch.data import projection as proj  # noqa: E402
from instancerefer_tpu_torch.models import enet  # noqa: E402
from instancerefer_tpu_torch.scripts import compute_multiview_features as t_compute  # noqa: E402
from instancerefer_tpu_torch.scripts import project_multiview_features as t_features  # noqa: E402
from instancerefer_tpu_torch.scripts import project_multiview_labels as t_labels  # noqa: E402

from test_torch_enet import random_state_dict  # noqa: E402

SCENES = ("scene0000_00", "scene0001_00")
FRAMES = 4


def write_fake_frames(root, seed: int = 0, num_points: int = 3000):
    """``{root}/scannet_data/{scene}_vert.npy`` and ``{root}/frames/{scene}/
    {color,depth,pose}/{i}.{jpg,png,txt}`` for ``SCENES`` x ``FRAMES``."""
    from imageio.v2 import imwrite

    rng = np.random.default_rng(seed)
    helper = t_features.projector("cpu")
    os.makedirs(os.path.join(root, "scannet_data"))
    for scene in SCENES:
        points = proj.room_scene(rng, num_points)
        verts = np.concatenate([points, rng.uniform(0, 255, size=points.shape)], 1)
        np.save(os.path.join(root, "scannet_data", f"{scene}_vert.npy"), verts.astype(np.float32))
        base = os.path.join(root, "frames", scene)
        for sub in ("color", "depth", "pose"):
            os.makedirs(os.path.join(base, sub))
        for i in range(FRAMES):
            eye = rng.uniform([1.0, 1.0, 1.2], [5.0, 4.0, 1.8])
            pose = proj.look_at(eye, rng.uniform([0.0, 0.0, 0.0], [6.0, 5.0, 1.5]))
            np.savetxt(os.path.join(base, "pose", f"{i}.txt"), pose, fmt="%.8f")
            pose = t_features.load_pose(os.path.join(base, "pose", f"{i}.txt"))
            depth = proj.zbuffer_depth(points, pose, helper).numpy()
            imwrite(os.path.join(base, "depth", f"{i}.png"),
                    np.round(depth * 1000).astype(np.uint16))
            imwrite(os.path.join(base, "color", f"{i}.jpg"),
                    rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8))
    return root


def run_jax_script(monkeypatch, module, argv):
    import importlib

    mod = importlib.import_module(f"scripts.{module}")
    monkeypatch.setattr(sys, "argv", [module, *argv])
    mod.main()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    import jax
    import orbax.checkpoint as ocp

    from scripts.convert_enet import convert_state_dict

    root = str(tmp_path_factory.mktemp("frames"))
    write_fake_frames(root)
    sd = random_state_dict(3)
    model = enet.Enet().eval()
    model.load_state_dict(sd)
    image = t_compute.load_image(f"{root}/frames/{SCENES[0]}/color/0.jpg", t_compute.FRAME_DIMS)
    mu = torch.from_numpy(t_compute.frame_features(model, image[None], "cpu")[0]).mean((1, 2))
    w = sd["26.0.weight"][:, :, 0, 0]
    sd["26.0.weight"] = (w - (w @ mu)[:, None] * mu / (mu @ mu))[:, :, None, None].contiguous()
    torch.save(sd, os.path.join(root, "enet.pth"))
    full = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    encoder = {"params": full["params"]["encoder"], "batch_stats": full["batch_stats"]["encoder"]}
    with ocp.StandardCheckpointer() as ckptr:
        for name, tree in (("enet_full", full), ("enet_encoder", encoder)):
            ckptr.save(os.path.join(root, name), jax.tree.map(np.asarray, tree), force=True)
    return root


@pytest.fixture(scope="module")
def features(root):
    """Each side's per-frame feature npys: {side: directory}."""
    mp = pytest.MonkeyPatch()
    try:
        run_jax_script(mp, "compute_multiview_features", [
            "--frames", f"{root}/frames", "--out", f"{root}/feats_jax",
            "--weights", f"{root}/enet_encoder", "--batch", "3"])
    finally:
        mp.undo()
    t_compute.main(["--frames", f"{root}/frames", "--out", f"{root}/feats_torch",
                    "--weights", f"{root}/enet.pth", "--batch", "3", "--device", "cpu"])
    return {"jax": f"{root}/feats_jax", "torch": f"{root}/feats_torch"}


def test_frame_features_match(features):
    n = 0
    for scene in SCENES:
        names = sorted(os.listdir(os.path.join(features["jax"], scene)))
        assert names == sorted(os.listdir(os.path.join(features["torch"], scene)))
        assert len(names) == FRAMES
        for name in names:
            want = np.load(os.path.join(features["jax"], scene, name))
            got = np.load(os.path.join(features["torch"], scene, name))
            assert got.shape == want.shape == (128, 32, 41) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
            n += 1
    assert n == len(SCENES) * FRAMES


@pytest.mark.parametrize("maxpool", [True, False])
def test_feature_databases_match(monkeypatch, root, features, maxpool):
    import h5py

    flags = ["--maxpool"] if maxpool else []
    common = ["--scannet_data", f"{root}/scannet_data", "--frames", f"{root}/frames",
              "--features", features["jax"]]
    tag = "max" if maxpool else "first"
    run_jax_script(monkeypatch, "project_multiview_features",
                   [*flags, *common, "--out", f"{root}/jax_{tag}.hdf5"])
    t_features.main([*flags, *common, "--out", f"{root}/torch_{tag}.hdf5", "--device", "cpu"])
    with h5py.File(f"{root}/jax_{tag}.hdf5", "r") as want, \
            h5py.File(f"{root}/torch_{tag}.hdf5", "r") as got:
        assert sorted(got) == sorted(want) == list(SCENES)
        for scene in SCENES:
            w, g = np.asarray(want[scene]), np.asarray(got[scene])
            assert g.shape == w.shape == (3000, 128) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            covered = (w != 0).any(1).mean()
            assert covered > 0.2, covered


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    body = np.array([line.split() for line in lines[end + 1:]])
    return lines[:end + 1], body[:, :3], body[:, 3:].astype(int)


@pytest.mark.parametrize("maxpool", [True, False])
def test_label_plys_match(monkeypatch, root, maxpool):
    flags = ["--maxpool"] if maxpool else []
    common = ["--scannet_data", f"{root}/scannet_data", "--frames", f"{root}/frames"]
    tag = "max" if maxpool else "first"
    run_jax_script(monkeypatch, "project_multiview_labels",
                   [*flags, *common, "--out", f"{root}/ply_jax_{tag}",
                    "--weights", f"{root}/enet_full"])
    t_labels.main([*flags, *common, "--out", f"{root}/ply_torch_{tag}",
                   "--weights", f"{root}/enet.pth", "--device", "cpu"])
    for scene in SCENES:
        head_w, xyz_w, rgb_w = _read_ply(f"{root}/ply_jax_{tag}/{scene}.ply")
        head_g, xyz_g, rgb_g = _read_ply(f"{root}/ply_torch_{tag}/{scene}.ply")
        assert head_g == head_w and (xyz_g == xyz_w).all()
        differ = (rgb_g != rgb_w).any(1).mean()
        assert differ <= 1e-3, differ
        assert len({tuple(c) for c in rgb_w}) > 5  # labels, not one color


def test_scripts_need_a_card_unless_told_cpu(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for module in (t_compute, t_features, t_labels):
        with pytest.raises(SystemExit, match="--device cpu"):
            module.main(["--frames", f"{root}/frames", "--out", f"{root}/unused"])
