"""The port's host-pipeline bench (``instancerefer_tpu_torch/scripts/
bench_host_pipeline.py``) and the ``timings`` hook of its ``pad_sample``
that the bench reads, against the JAX package's.

* ``pad_sample`` with ``timings`` gives the arrays it gives without them,
  bit for bit, and those equal the JAX package's (``pallas_conv=True``) on
  every key the port holds: ``TEST_SPEC`` and the bench's fitted caps, 2
  seeds each.
* Its phases carry the JAX package's names, less the band phases the port
  does not build; each is non-negative and together they are no more than
  the call.
* The schemas of ``phase_split``, ``collate_scaling``, ``loader_scaling``
  and the script's JSON.  No test here holds a time to a limit.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from instancerefer_tpu.data import pipeline as jpipeline
from instancerefer_tpu.data import synthetic as jsynthetic

from instancerefer_tpu_torch.data import pipeline, synthetic
from instancerefer_tpu_torch.scripts import bench_host_pipeline as hb

MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
# the bench's caps (config/band_profile.synthetic.yaml)
BENCH_SPEC = pipeline.BatchSpec(
    scene_caps=(18176, 4352, 1280, 512, 256), inst_caps=(1792, 1792, 1280, 512, 256),
    max_candidates=8, max_instances=24,
)
SPECS = {"test": (synthetic.TEST_SPEC, dict(num_candidates=3)),
         "bench": (BENCH_SPEC, dict(num_points=40000, num_instances=12, num_candidates=4))}
PHASES = {"scene_quantize", "scene_pyramid", "scene_inverse", "inst_quantize", "inst_pyramid",
          "inst_inverse", "sample_misc"}


def jax_spec(spec):
    return jpipeline.BatchSpec(**dataclasses.asdict(spec), pallas_conv=True)


def cores(which, seed):
    """The same sample from both packages' generators."""
    spec, kw = SPECS[which]
    port = synthetic.make_core_sample(np.random.default_rng(seed), mean_size_arr=MEAN_SIZE, **kw)
    jax = jsynthetic.make_core_sample(np.random.default_rng(seed), mean_size_arr=MEAN_SIZE, **kw)
    return spec, port, jax


@pytest.mark.parametrize("which", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_timed_pad_sample_equals_untimed_and_jax(which, seed):
    spec, core, jcore = cores(which, seed)
    timings = {}
    timed = pipeline.pad_sample(core, spec, timings=timings)
    plain = pipeline.pad_sample(core, spec)
    want = jpipeline.pad_sample(jcore, jax_spec(spec))
    assert timings and timed.keys() == plain.keys()
    for key, value in timed.items():
        assert value.dtype == plain[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(value, plain[key], err_msg=key)
        np.testing.assert_array_equal(value, want[key], err_msg=key)


@pytest.mark.parametrize("which", sorted(SPECS))
def test_phases_carry_the_jax_names_less_the_bands(which):
    spec, core, jcore = cores(which, 2)
    got, want = {}, {}
    t0 = time.perf_counter()
    pipeline.pad_sample(core, spec, timings=got)
    total = time.perf_counter() - t0
    jpipeline.pad_sample(jcore, jax_spec(spec), timings=want)
    assert set(got) == {k for k in want if not k.endswith("_bands")} == PHASES
    assert all(v >= 0 for v in got.values())
    assert sum(got.values()) <= total


def test_scene_block_timings_and_the_cache_path():
    """``build_scene_block`` times its own phases; a cached block (no scene
    work) gives the same sample and times no scene phase."""
    spec, core, _ = cores("test", 3)
    t_block = {}
    block = pipeline.build_scene_block(core.point_cloud, spec, timings=t_block)
    assert set(t_block) == {"scene_quantize", "scene_pyramid", "scene_inverse", "sample_misc"}
    t_cached = {}
    cached = pipeline.pad_sample(core, spec, scene_block=block, timings=t_cached)
    plain = pipeline.pad_sample(core, spec)
    assert not any(k.startswith("scene_") for k in t_cached)
    for key, value in plain.items():
        np.testing.assert_array_equal(cached[key], value, err_msg=key)


def test_phase_split_schema_and_median_ms():
    _, core, _ = cores("test", 0)
    out = hb.phase_split(core, synthetic.TEST_SPEC, reps=3)
    assert set(out) == {f"{p}_ms" for p in PHASES} | {"pad_sample_total_ms", "accounted_frac"}
    assert all(np.isfinite(v) and v >= 0 for v in out.values())
    calls = []
    assert hb.median_ms(lambda: calls.append(1), reps=3) >= 0
    assert len(calls) == 4  # one warm call and 3 timed


def _cores(n):
    rng = np.random.default_rng(4)
    return [synthetic.make_core_sample(rng, scan_idx=i, mean_size_arr=MEAN_SIZE)
            for i in range(n)]


def test_collate_scaling_schema():
    out = hb.collate_scaling(_cores(3), synthetic.TEST_SPEC, 4, [1, 2], reps=2)
    assert set(out) == {"serial_ms", "pooled_jobs_ms", "serial_share_ms", "pool1_ms",
                        "pool2_ms"}
    assert all(v >= 0 for v in out.values())


def test_loader_scaling_counts_every_sample():
    out = hb.loader_scaling(_cores(5), synthetic.TEST_SPEC, 2, [0, 2])
    assert set(out) == {0, 2} and all(v > 0 for v in out.values())


def test_main_prints_one_json_line(capsys):
    result = hb.main(["--samples", "2", "--points", "2000", "--batch_size", "2", "--workers",
                      "0", "1", "--collate-workers", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert set(result) == {"native_voxelizer", "points_per_scene", "phase_ms",
                           "samples_per_sec_by_workers", "collate_ms", "ncpu"}
    assert set(result["samples_per_sec_by_workers"]) == {"0", "1"}
    assert set(result["phase_ms"]) >= {f"{p}_ms" for p in PHASES}
