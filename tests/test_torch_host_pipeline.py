"""The port's own host pipeline (``instancerefer_tpu_torch/data``,
``ops/voxelize.py``, ``native/voxelizer.cpp``) and kernel permutations
(``utils/convert._PERM3``/``_PERM2``) against the JAX package's.

* ``make_batch``/``collate``: bit for bit, on every key the port's batch
  holds, equal to the JAX package's with ``pallas_conv=True`` (the raster
  row order the port always uses), for ``TEST_SPEC`` and for the smoke's
  fitted caps, over several seeds.
* Both ``ScannetReferenceDataset``s and ``PaddedLoader``s on a
  ``tests/fake_scanrefer`` root, augmentation on (train) and off with the
  scene-block cache (val): the same batches, bit for bit; and each rank's
  loader of 2 against the JAX package's host loader of 2.
* The port's native voxelizer against its numpy path.
* ``_PERM3``/``_PERM2`` against ``convert_torch``'s, which its exporter
  applies.
"""

import dataclasses

import numpy as np
import pytest

from instancerefer_tpu.data import dataset as jdataset
from instancerefer_tpu.data import pipeline as jpipeline
from instancerefer_tpu.data import synthetic as jsynthetic
from instancerefer_tpu.utils import convert_torch

from instancerefer_tpu_torch.data import dataset, pipeline, synthetic
from instancerefer_tpu_torch.ops import voxelize as V
from instancerefer_tpu_torch.utils import convert

from fake_scanrefer import make_fake_root

# the smoke's spec: config/band_profile.synthetic.yaml's fitted caps
SMOKE_SPEC = pipeline.BatchSpec(
    scene_caps=(18176, 4352, 1280, 512, 256), inst_caps=(1792, 1792, 1280, 512, 256),
    max_candidates=8, max_instances=24,
)
SPECS = {"test": (synthetic.TEST_SPEC, {}),
         "smoke": (SMOKE_SPEC, dict(num_points=40000, num_instances=12, num_candidates=4))}


def jax_spec(spec):
    """The JAX package's spec of the same capacities, in raster order."""
    return jpipeline.BatchSpec(**dataclasses.asdict(spec), pallas_conv=True)


def assert_same_batch(got, want):
    assert set(got) <= set(want), set(got) - set(want)
    for key, value in got.items():
        assert value.dtype == want[key].dtype, key
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_specs_match_jax_defaults():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jpipeline.BatchSpec)}
    for f in dataclasses.fields(pipeline.BatchSpec):
        assert jax_fields[f.name] == f.default, f.name
    assert dataclasses.asdict(synthetic.TEST_SPEC) == {
        k: v for k, v in dataclasses.asdict(jsynthetic.TEST_SPEC).items()
        if k in dataclasses.asdict(synthetic.TEST_SPEC)}


@pytest.mark.parametrize("which", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_batch_equals_jax_raster_batch(which, seed):
    spec, kw = SPECS[which]
    mean_size = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
    got = synthetic.make_batch(2, spec, seed=seed, mean_size_arr=mean_size, **kw)
    want = jsynthetic.make_batch(2, jax_spec(spec), seed=seed, mean_size_arr=mean_size, **kw)
    assert_same_batch(got, want)
    assert "scene_uprow_4" in got and not any("ws3" in k or "band" in k for k in got)


def test_partial_batch_equals_jax():
    spec = dataclasses.replace(synthetic.TEST_SPEC, lang_bucket=8)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    samples = [pipeline.pad_sample(synthetic.make_core_sample(rng, scan_idx=i), spec)
               for i in range(3)]
    jsamples = [jpipeline.pad_sample(jsynthetic.make_core_sample(jrng, scan_idx=i),
                                     jax_spec(spec)) for i in range(3)]
    got = pipeline.finalize_batch(samples, 4, spec)
    assert_same_batch(got, jpipeline.finalize_batch(jsamples, 4, jax_spec(spec)))
    assert got["sample_valid"].tolist() == [True, True, True, False]


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr")
    make_fake_root(root, np.random.default_rng(0))
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
def test_loaders_equal_jax_on_a_fake_root(fake_root, split):
    """Train: augmentation on, points redrawn per annotation; val: one
    static draw per scene and the scene-block cache."""
    spec = dataclasses.replace(synthetic.TEST_SPEC, lang_bucket=8)
    batches = []
    for mod, s in ((dataset, spec), (jdataset, jax_spec(spec))):
        ds = mod.ScannetReferenceDataset(
            mod.get_scanrefer(fake_root, split), split, data_root=fake_root,
            num_points=500, use_augment=True, seed=7)
        assert ds.augment == (split == "train")
        loader = mod.PaddedLoader(ds, s, 4, shuffle=True, seed=3, num_workers=2)
        batches.append([b for _ in range(2) for b in loader])  # two epochs
    assert len(batches[0]) == len(batches[1]) == 4
    for got, want in zip(*batches):
        assert_same_batch(got, want)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("process_index", [0, 1])
def test_rank_loader_equals_jax_host_loader(fake_root, split, process_index):
    """Rank ``process_index`` of 2: its shard of the global permutation,
    collated on the global batch's language grid, equals the JAX package's
    host batch bit for bit, over two epochs, its length too."""
    # descriptions of 2 and 6 tokens: a rank's own batch can need a shorter
    # grid than the global batch's
    spec = dataclasses.replace(synthetic.TEST_SPEC, lang_bucket=2)
    batches, lengths = [], []
    for mod, s in ((dataset, spec), (jdataset, jax_spec(spec))):
        ds = mod.ScannetReferenceDataset(
            mod.get_scanrefer(fake_root, split), split, data_root=fake_root,
            num_points=500, use_augment=True, seed=7)
        loader = mod.PaddedLoader(ds, s, 2, shuffle=True, seed=3, num_workers=2,
                                  process_index=process_index, process_count=2)
        lengths.append(len(loader))
        batches.append([b for _ in range(2) for b in loader])  # two epochs
    assert lengths[0] == lengths[1] and len(batches[0]) == len(batches[1]) == 2 * lengths[0] > 0
    for got, want in zip(*batches):
        assert_same_batch(got, want)


def test_native_library_is_the_ports_own():
    assert V.native_available()
    path = V.native_library_path()
    assert path.startswith(V.BUILD_DIR) and path.endswith(".so")


def _numpy(fn, *args):
    saved = V._NATIVE
    V._NATIVE = None
    try:
        return fn(*args)
    finally:
        V._NATIVE = saved


@pytest.mark.parametrize("seed", [0, 1])
def test_native_voxelizer_equals_numpy_path(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=2.0, size=(3000, 3)) - 1.0  # negative coords too
    feats = rng.normal(size=(3000, 7)).astype(np.float32)
    for got, want in zip(V.quantize(xyz, feats, 0.05), _numpy(V.quantize, xyz, feats, 0.05)):
        np.testing.assert_array_equal(got, want)
    coords, _ = V.quantize(xyz, feats, 0.05)
    for stride in (1, 2):
        np.testing.assert_array_equal(V.build_nbr3(coords, stride),
                                      _numpy(V.build_nbr3, coords, stride))
        for got, want in zip(V.build_downsample(coords, stride),
                             _numpy(V.build_downsample, coords, stride)):
            np.testing.assert_array_equal(got, want)
    _, down = V.build_downsample(coords, 1)
    for got, want in zip(V.invert_down(down, len(coords)),
                         _numpy(V.invert_down, down, len(coords))):
        np.testing.assert_array_equal(got, want)
    pts = rng.normal(size=(500, 7)).astype(np.float32)
    for got, want in zip(V.point_minmax3(pts), _numpy(V.point_minmax3, pts)):
        np.testing.assert_array_equal(got, want)

    groups = [V.quantize(rng.normal(scale=0.3, size=(int(n), 3)) + rng.normal(size=3),
                         np.zeros((int(n), 1)), 0.02)[0]
              for n in rng.integers(50, 800, size=3)]
    for caps in ((2048, 512, 256, 64, 16), (64, 32, 16, 16, 16)):  # fits, then truncates
        got, got_n = V.build_pyramid_padded(groups, range(3), caps)
        want, want_n = _numpy(V.build_pyramid_padded, groups, range(3), caps)
        assert got_n == want_n
        for a, b in zip(got, want):
            for field in ("coords", "owner", "nbr3", "down"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


@pytest.mark.parametrize("ks", [3, 2])
def test_offset_permutation_equals_jax_exporter(ks):
    """The port's kernel permutation at kernel size ``ks`` (the one
    ``from_reference``/``to_reference`` apply) is the JAX exporter's, over
    the same torchsparse offsets, and a bijection of the ks^3 offsets."""
    got = {3: convert._PERM3, 2: convert._PERM2}[ks]
    want = {3: convert_torch._PERM3, 2: convert_torch._PERM2}[ks]
    np.testing.assert_array_equal(convert.torchsparse_offsets(ks),
                                  convert_torch.torchsparse_offsets(ks))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(ks ** 3))
