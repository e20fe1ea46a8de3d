"""The benchmark's own counts on one generated batch, against the port's
arithmetic they were copied from: the reference's maps hold the valid
entries of the program's, and the FLOPs and least times come out as
``scripts/bench.py``'s and ``scripts/step_ab.shape_bounds`` (which
``scripts/conv_bytes.py`` prints) do on the program's padded maps."""

import numpy as np
import pytest
import torch

from benchmark import counts, program, scenes
from benchmark.reference import batch as ref_batch

VALUES = {"num_classes": 18, "use_color": True, "use_height": True, "use_normal": False,
          "use_multiview": False, "voxel_size_ap": 0.02, "voxel_size_glp": 0.05, "k": 8,
          "max_instances": 16, "max_candidates": 4, "max_des_len": 24, "lang_bucket": 8,
          "scene_caps": [2048, 1024, 512, 256, 128], "inst_caps": [1024, 512, 256, 128, 64]}
TRAFFIC = {"batch": 3, "pool_batches": 1, "lang_len": {"median": 8, "sigma": 0.5, "min": 3,
                                                       "max": 24},
           "scene": {"num_points": 1500, "num_instances": 6, "num_candidates": 3,
                     "points_per_instance": 64, "scene_extent": 2.0}}


@pytest.fixture(scope="module")
def both():
    pool = scenes.make_pool(11, TRAFFIC, False)
    cfg = program.config(VALUES)
    batch = program.batches(pool, cfg, 2)[0]
    assert max(float(batch[k].max()) for k in batch if k.endswith("overflow")) == 0
    return batch, cfg.batch_spec(), ref_batch.prepare(pool[0], VALUES, torch.device("cpu"))


def test_valid_entries_equal_the_program_maps(both):
    batch, _, prepared = both
    shapes = ref_batch.conv_shapes(prepared, 7)
    keys = []
    for p in ("scene", "inst"):
        keys.append(f"{p}_nbr3_0")
        for s in range(1, 5):
            keys += [f"{p}_down_{s}", f"{p}_nbr3_{s}", f"{p}_nbr3_{s}"]
    assert [nnz for _, nnz, *_ in shapes] == [int((batch[k] >= 0).sum()) for k in keys]


def test_flops_equal_bench_py(both):
    from instancerefer_tpu_torch.scripts import bench

    batch, spec, prepared = both
    shapes = ref_batch.conv_shapes(prepared, 7)
    got = counts.step_flops(shapes, "eval", 3, spec.scene_caps[-1], spec.max_tokens)
    assert got == bench.model_flops_valid(batch, spec)
    assert counts.step_flops(shapes, "train", 3, spec.scene_caps[-1], spec.max_tokens) == 3 * got


def test_bounds_equal_shape_bounds(both):
    from instancerefer_tpu_torch.scripts import step_ab

    batch, _, _ = both
    want = step_ab.shape_bounds(batch)
    for label, wrapper, key, in_key, cin, cout in step_ab.SHAPES:
        if "Cin" in label:
            continue
        nbr = step_ab.shape_map(batch, key)
        kernel = {"gather_conv": "K1", "gather_conv_dx": "K1 dX", "subm_conv_bwd": "K2",
                  "conv_dw": "K3"}[wrapper]
        nnz = int((nbr >= 0).sum())
        got = counts.bound_ms(kernel, nnz, batch[in_key].shape[0], nbr.shape[0], nbr.shape[1],
                              cin, cout)
        assert (nnz, got) == (want[label][0], pytest.approx(want[label][1], rel=1e-12)), label


def test_launches_of_a_train_step(both):
    _, _, prepared = both
    kinds = [k for k, _ in counts.launch_bounds(ref_batch.conv_shapes(prepared, 7), "train")]
    # K1: 26 forward convs and the 8 downs' dX; K2: 16 residual convs; K3: 2 stems, 8 downs
    assert (kinds.count("K1") + kinds.count("K1 dX"), kinds.count("K2"), kinds.count("K3")) \
        == (34, 16, 10)
    assert np.isclose(sum(b for _, b in counts.launch_bounds(
        ref_batch.conv_shapes(prepared, 7), "eval")), sum(
        b for k, b in counts.launch_bounds(ref_batch.conv_shapes(prepared, 7), "train")
        if k == "K1"))


def test_caps_odds_match_a_brute_count():
    """``benchmark.caps``: the candidate count's law and the overflow odds
    of summed rows, against sums drawn one by one."""
    from benchmark import caps

    law = caps.candidate_law(TRAFFIC, 4)
    assert sorted(law) == [3, 4] and sum(law.values()) == pytest.approx(1.0)
    rows = caps.candidate_rows(400, TRAFFIC, 0.02, 3, seed=5)
    assert rows.shape == (400, 3) and (np.diff(rows, axis=1) <= 0).all()
    odds = caps.overflow_odds(rows[:, 1], law)
    rng = np.random.default_rng(6)
    ks = rng.choice(list(law), size=20000, p=list(law.values()))
    sums = np.array([rng.choice(rows[:, 1], size=k).sum() for k in ks])
    for x in np.percentile(sums, [10, 50, 90]).astype(int):
        assert odds[x] == pytest.approx(float((sums > x).mean()), abs=0.02)
