"""The benchmark's PointGroup cell on the CPU: the rehearsal of
``pointgroup-train-resident`` (``benchmark.run --rehearse``: the cell's
driver at the sizes of its traffic's ``rehearse`` key, in f32, every metric
null, ``correct`` from the plain reference), the counts over the
reference's maps (``benchmark/reference/pointgroup.py``), and the metric
readers on records with and without what they read."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import counts_pointgroup
from benchmark.reference import pointgroup as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("mfu.pointgroup", "unet_roofline.pointgroup", "up_roofline.pointgroup",
       "device_idle_share.pointgroup", "host_issue_ms.pointgroup")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rehearsal_of_the_cell_is_correct_with_its_metrics_null():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "pointgroup-train-resident", "--seed", "2147483905", "--seconds", "1",
                           "--trace", "1", "--rehearse"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == set(NEW)
    assert all(m["value"] is None for m in result["metrics"].values())


def test_the_limits_fail_the_control_and_each_fault_in_the_rehearsal():
    """The reference in the program's place in the rehearsal's rooms, its
    sparse convs in float8 e4m3 (the control) and with each fault planted:
    ``check.judge`` refuses every one under the cell's limits.  Nothing is
    cut in these rooms, so ``caps_exceeded`` reads the sound run's 0 and
    only the planted change decides."""
    from benchmark import check
    from benchmark import run as bench_run
    from benchmark.drivers import pointgroup as drv

    _, values, traffic, _, _, limits = bench_run.cell_data(ROOT, "pointgroup-train-resident",
                                                           rehearse=True)
    kinds = ["control", "frozen", "half", "altered"]
    sizes = {**drv.sizes(traffic, True), "pool_batches": 2}  # two of the rehearsal's three
    got = drv.readings(2147483905, values, sizes, torch.device("cpu"), kinds)
    for kind in kinds:
        numbers = {**got[kind], "caps_exceeded": 0.0}
        failed = [k for k, v in limits.items() if not numbers[k] <= v]
        assert not check.judge(numbers, limits), f"{kind} passes every limit: {numbers}"
        assert failed, kind
    # the control fails by precision: the statistics, which no fault moves
    assert got["control"]["stats_gap"] > limits["stats_gap"]


def test_counts_follow_the_reference_maps():
    from benchmark.drivers.pointgroup import make_room

    rng = np.random.default_rng(1)
    rooms = {"points": [400, 400], "side_m": [4.0, 4.0], "height_m": 3.0,
             "instances": [8, 8], "unlabeled": 0.05}
    room = make_room(rng, rooms)
    assert len(room["xyz"]) == 400 and set(np.unique(room["ins"])) >= {0, 1}
    batch = R.prepare([{k: torch.from_numpy(np.asarray(v)) for k, v in room.items()}], 50.0, 7)
    shapes = counts_pointgroup.conv_shapes(batch, 16, 7, 2)
    kinds = [s[0] for s in shapes]
    # the input conv, 4 convs a level's blocks, 6 downs and inverse convs, 4 convs
    # and a 1 x 1 a level's tails
    assert kinds.count("stem") == 1 and kinds.count("down") == kinds.count("up") == 6
    assert kinds.count("subm") == 7 * 4 + 6 * 4 and kinds.count("one") == 6
    bounds = counts_pointgroup.launch_bounds(shapes)
    assert sum(up for _, up, _ in bounds) == 18 and all(b > 0 for _, _, b in bounds)
    assert counts_pointgroup.step_flops(shapes, 400) > 0


def test_readers_read_what_a_pointgroup_record_holds():
    prof = {"agrees": True, "busy_s": 0.6, "window_s": 1.0, "bound_s": 0.1, "up_bound_s": 0.01,
            "up_s": 0.04, "steps": 2,
            "kernel_s": {"void irsc::tc::gather_gemm_tc_kernel<bf16, 16, 16, false>": 0.3,
                         "void irsc::tc::up_fwd_tc_kernel<16, 32>": 0.04,
                         "elementwise": 0.2}}
    rec = {"model": "pointgroup", "phase": "train", "driver": "resident", "flops": 9.89e12,
           "window_s": 1.0, "profile": prof}
    assert _reader("mfu.pointgroup")(rec) == pytest.approx(1.0)
    assert _reader("unet_roofline.pointgroup")(rec) == pytest.approx(100 * 0.1 / 0.34)
    assert _reader("up_roofline.pointgroup")(rec) == pytest.approx(25.0)
    assert _reader("device_idle_share.pointgroup")(rec) == pytest.approx(40.0)
    other = {"phase": "train", "driver": "resident", "window_s": 1.0, "profile": prof}
    for name in NEW:
        assert _reader(name)(other) is None
