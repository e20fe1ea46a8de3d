"""The port's ScanNet exporter (``instancerefer_tpu_torch/data/prepare.py``)
and its CLIs against the JAX package's, on the CPU.

Scans come from ``data/synthetic_scans.py`` (ScanNet's raw layouts, a seed
each).  Limits: the label files and the subsample's rows equal; normals
within 1e-6 (float64 sums in another order, cast to float32); coordinates
and boxes within 1 float32 ulp (a float64 product in another order).
"""

import json
import os
import runpy
import struct
import sys

import numpy as np
import pytest
import torch

from instancerefer_tpu.data import prepare as J

from instancerefer_tpu_torch.data import prepare as P
from instancerefer_tpu_torch.data import synthetic_scans as S
from instancerefer_tpu_torch.scripts import prepare_data, visualize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMAL_TOL = 1e-6


def assert_same_ply(got, want):
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for key, w in want[name].items():
            g = got[name][key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key, g.dtype, w.dtype)
            if w.dtype == object:
                assert [list(x) for x in g] == [list(x) for x in w], (name, key)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{key}")


def _ascii_ply(path, xyz, rgb, faces):
    lines = ["ply", "format ascii 1.0", "comment ascii", f"element vertex {len(xyz)}",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green", "property uchar blue",
             f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    lines += [f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}" for p, c in zip(xyz, rgb)]
    lines += [" ".join(str(v) for v in [len(f), *f]) for f in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _binary_ply(path, xyz, faces, count="uchar", index="int", texcoord=False, name="face"):
    """Faces as records of (count, indices[, 6, texcoords]), struct by
    struct."""
    c, i = P._PLY_TYPES[count][0], P._PLY_TYPES[index][0]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\nproperty float x\nproperty float y\nproperty float z\n"
              f"element {name} {len(faces)}\nproperty list {count} {index} vertex_indices\n"
              + ("property list uchar float texcoord\n" if texcoord else "")
              + "end_header\n")
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(np.asarray(xyz, "<f4").tobytes())
        for k, f in enumerate(faces):
            fh.write(struct.pack("<" + c + i * len(f), len(f), *f))
            if texcoord:
                fh.write(struct.pack("<B6f", 6, *np.linspace(0, 1, 6) * k))


@pytest.mark.parametrize("kind", ["binary", "binary_ushort_uint", "ascii", "non_uniform",
                                  "two_lists", "float_list", "no_faces"])
def test_read_ply_matches_jax(tmp_path, rng, kind):
    """The one-``frombuffer`` read of a uniform face list, and the record by
    record read everywhere else, return JAX's dict."""
    xyz = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(40, 3)).astype(np.uint8)
    tris = rng.integers(0, 40, size=(30, 3))
    path = str(tmp_path / "mesh.ply")
    if kind == "binary":
        S.write_ply(path, xyz, rgb, tris)
    elif kind == "binary_ushort_uint":
        _binary_ply(path, xyz, tris, count="ushort", index="uint")
    elif kind == "ascii":
        _ascii_ply(path, xyz, rgb, tris)
    elif kind == "non_uniform":  # triangles and quads
        _binary_ply(path, xyz, [list(t) + ([int(t[0]) ^ 1] if k % 3 == 0 else [])
                                for k, t in enumerate(tris)])
    elif kind == "two_lists":
        _binary_ply(path, xyz, tris, texcoord=True)
    elif kind == "float_list":
        _binary_ply(path, xyz, rng.normal(size=(30, 4)), index="float", name="texcoord")
    else:
        S.write_ply(path, xyz, rgb, np.zeros((0, 3), np.int64))
    assert_same_ply(P.read_ply(path), J.read_ply(path))


def test_compute_normal_matches_jax(rng):
    """float64 normals of a synthetic room's mesh within 1e-12 of
    ``np.add.at``'s order; vertices in no face, and a degenerate face's,
    give 0, as in JAX."""
    verts, _, faces, _, _, _ = S.make_scan(rng, 3000, 6000, 4)
    faces[0] = [3, 3, 3]  # degenerate
    got = P.compute_normal(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    want = J.compute_normal(verts, faces)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    isolated = np.ones(len(verts), bool)
    isolated[faces[1:].reshape(-1)] = False
    assert isolated.sum() >= S.ISOLATED and not np.abs(got[isolated]).any()


def test_instance_bboxes_match_jax(rng):
    """Boxes bit for bit: an object whose vertices a later object took (in
    the label map, no vertex) and one never labelled both keep zero rows."""
    xyz = rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32)
    ids = rng.integers(0, 7, size=2000).astype(np.uint32)
    ids[ids == 4] = 5  # object 4 lost its vertices
    labels = {1: 3, 2: 5, 3: 5, 4: 7, 5: 39, 6: 1}  # object 7 has no label, nor vertices
    want = J._instance_bboxes(xyz, ids, labels, 7)
    got = P._instance_bboxes(torch.from_numpy(xyz), torch.from_numpy(ids.astype(np.int64)),
                             labels, 7)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert not got[3].any() and not got[6].any()
    with pytest.raises(ValueError, match="beyond"):
        P._instance_bboxes(torch.from_numpy(xyz), torch.from_numpy(ids.astype(np.int64)),
                           labels, 5)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        P.torch_device("cuda")


TRAIN, TEST = ("scene0000_00", "scene0001_00"), ("scene0100_00",)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Two train scans of 60 000 vertices (above the 50 000 of the
    subsample), with PointGroup masks; the first one's aggregation gains an
    object that takes all of an earlier box's segments (that box keeps its
    label and no vertex) and an object with no segment.  One test scan
    without an aggregation."""
    root = str(tmp_path_factory.mktemp("raw"))
    rng = np.random.default_rng(8)
    S.write_scannet_scans(root, TRAIN, rng, num_verts=60000, num_faces=120000, num_masks=6)
    S.write_scannet_scans(root, TEST, rng, split="test", num_verts=6000, num_faces=12000,
                          num_masks=3)
    agg = os.path.join(root, "scans", TRAIN[0], f"{TRAIN[0]}.aggregation.json")
    data = json.load(open(agg))
    groups = data["segGroups"]
    n = len(groups)
    groups.append({"id": n, "objectId": n, "segments": groups[6]["segments"], "label": "lamp"})
    groups.append({"id": n + 1, "objectId": n + 1, "segments": [], "label": "sofa"})
    json.dump(data, open(agg, "w"))
    os.remove(os.path.join(root, "scans", TEST[0], f"{TEST[0]}.aggregation.json"))
    return root


def _export(module, root, out, split, **kw):
    return module.batch_export(split, os.path.join(root, "scans"),
                               os.path.join(root, "PointGroupInst"), out,
                               os.path.join(root, "meta_data"), **kw)


def assert_same_files(got_dir, want_dir, scans):
    for scan in scans:
        for key in P.ARTIFACTS:
            got = np.load(os.path.join(got_dir, f"{scan}_{key}.npy"))
            want = np.load(os.path.join(want_dir, f"{scan}_{key}.npy"))
            assert (got.dtype, got.shape) == (want.dtype, want.shape), (scan, key)
            if key.endswith("vert"):
                np.testing.assert_array_max_ulp(got[:, :6], want[:, :6], maxulp=1)
                np.testing.assert_allclose(got[:, 6:], want[:, 6:], rtol=0, atol=NORMAL_TOL)
            elif key.endswith("bbox"):
                np.testing.assert_array_max_ulp(got[:, :6].astype(np.float32),
                                                want[:, :6].astype(np.float32), maxulp=1)
                np.testing.assert_array_equal(got[:, 6:], want[:, 6:])
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{scan} {key}")


def test_batch_export_matches_jax(raw, tmp_path):
    """All eight files of every scan of both splits, with JAX's dtypes; the
    subsample ran and the masks were read."""
    for split, scans in (("train", TRAIN), ("test", TEST)):
        _export(J, raw, str(tmp_path / "jax"), split)
        times = _export(P, raw, str(tmp_path / "port"), split, device="cpu")
        assert sorted(times) == sorted(scans)
        assert all(set(t) == {"parse", "device", "save"} for t in times.values())
        assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), scans)
    verts = np.load(tmp_path / "port" / f"{TRAIN[0]}_vert.npy")
    assert verts.shape == (50000, 9) and verts.dtype == np.float32
    assert np.load(tmp_path / "port" / f"{TRAIN[0]}_ins_label_pg.npy").max() == 6
    assert np.load(tmp_path / "port" / f"{TEST[0]}_bbox.npy").shape == (1, 8)
    assert not np.load(tmp_path / "port" / f"{TEST[0]}_ins_label.npy").any()


def test_export_one_scan_takes_the_generator(raw, tmp_path):
    """An explicit generator draws the subsample as JAX's does; the
    returned artifacts are what was saved."""
    meta = os.path.join(raw, "meta_data", "scannetv2-labels.combined.tsv")
    args = (os.path.join(raw, "scans"), TRAIN[1])
    pg = os.path.join(raw, "PointGroupInst")
    want = J.export_one_scan(*args, str(tmp_path / "jax"), meta, pg, rng=np.random.default_rng(5))
    got = P.export_one_scan(*args, str(tmp_path / "port"), meta, pg,
                            rng=np.random.default_rng(5), device="cpu")
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["ins_label"], want["ins_label"])
    np.testing.assert_array_equal(got["vert"], np.load(f"{tmp_path / 'port'}_vert.npy"))


def _run_jax_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(ROOT, "scripts", name), run_name="__main__")


def test_prepare_and_visualize_clis_match_the_jax_scripts(raw, tmp_path, monkeypatch, capsys):
    """``scripts/prepare_data`` with ``--device cpu`` writes the JAX
    script's files; ``scripts/visualize --boxes`` on them writes the JAX
    script's bytes."""
    def flags(out):
        return ["--split", "train", "--scannet_path", os.path.join(raw, "scans"),
                "--pointgroupinst_path", os.path.join(raw, "PointGroupInst"),
                "--output_path", out, "--meta_path", os.path.join(raw, "meta_data")]

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax_script("prepare_data.py", flags(jax_out), monkeypatch)
    times = prepare_data.main(flags(port_out) + ["--device", "cpu"])
    assert sorted(times) == sorted(TRAIN)
    assert f"{TRAIN[0]}: parse" in capsys.readouterr().out
    assert_same_files(port_out, jax_out, TRAIN)

    viz = ["--scene", TRAIN[0], "--data", port_out, "--boxes"]
    _run_jax_script("visualize.py", viz + ["--out", str(tmp_path / "viz_jax")], monkeypatch)
    written = visualize.main(viz + ["--out", str(tmp_path / "viz_port")])
    names = [f"{TRAIN[0]}_vert.obj", f"{TRAIN[0]}_aligned_vert.obj", f"{TRAIN[0]}_bbox.obj"]
    assert [os.path.basename(p) for p in written] == names
    for name in names:
        got = open(tmp_path / "viz_port" / name, "rb").read()
        assert got == open(tmp_path / "viz_jax" / name, "rb").read(), name
    boxes = np.load(os.path.join(port_out, f"{TRAIN[0]}_aligned_bbox.npy"))
    text = open(tmp_path / "viz_port" / names[2]).read()
    assert text.count("\nv ") + text.startswith("v ") == 8 * len(boxes)
    assert open(tmp_path / "viz_port" / names[0]).read().count("\n") == 50000
