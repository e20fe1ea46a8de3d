"""PointGroup's first training phase, resident: a pool of batches of whole
synthetic rooms built on the host and staged on the device in set-up, then
a closed loop of train steps over it, as the port's solver runs one
(``StepGraphs.load`` of the next batch into its graph's inputs, the step,
the metrics to the host).  The host feed is bypassed.

The rooms (``make_room``) are a copy of the port's ``data/synthetic_scans.
make_scan`` room generator at ScanNet's scale: a floor, four walls 3 m high
and furniture boxes, each surface a grid of vertices, 100 000 - 250 000
points a room (log-uniform), 4-10 m a side, 10-40 instances over ScanNet's
20 classes (the floor and the walls among them), about 5% of the points of
no class and no instance, and some points in no surface.  The traffic file
gives the ranges under ``rooms``; ``rehearse`` holds the CPU rehearsal's
sizes (``run.py --rehearse`` overlays ``batch`` and ``scene``, which this
driver does not read).

Set-up builds and stages the pool, loads the benchmark's weights
(``reference/pointgroup.init_state``) and runs one pass over the pool: the
first step runs eagerly and is captured, the rest replay.  Its first three
steps from the weights are the start the check follows; a second pass,
every step a replay, is the replays it follows, each step from the whole
state taken before it.  The check (``benchmark/check.py``'s numbers) holds
them against ``reference/pointgroup``, which builds its own maps from the
rooms' arrays.  ``caps_exceeded`` counts the rows and points the
configuration's capacities would cut (none may be).

With ``--trace 1`` a window of whole passes under the profiler: its
launches held against the program's counters (the inverse convs' kernels
with K1's), ``flops`` and each sparse launch's least time from
``counts_pointgroup`` over the reference's maps.

    python3 -m benchmark.drivers.pointgroup --fit-caps [--rooms 400]
    python3 -m benchmark.drivers.pointgroup --readings --seeds 11 12 [--faults] [--witness]

print the level capacities fitted to the traffic, and the readings of the
reference in the program's place with its sparse convs in float8 e4m3 (the
control), with them in bfloat16 (``--witness``: what the program's
storage alone moves) and with each fault of ``reference/pointgroup.
train_steps`` planted, from which the limits are set
(``benchmark.calibrate --program`` gives the sound program's).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import sys
import time
import types
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, counts_pointgroup, program, trace
from benchmark.drivers.resident import _replays
from benchmark.reference import pointgroup as ref_pg

CHECKED = 3  # the start's steps the reference follows
PROFILE_S = 0.5  # the traced window's least length
# the 20 classes' nyu40 ids: the floor, the walls, and the furniture classes
FLOOR, WALL = 2, 1
FURNITURE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
ISOLATED = 0.003  # the share of a room's points in no surface
# the program's sparse kernels by the counter that counts them: the port's
# families (metrics/_kernel_names.py), the inverse convs' three with K1's
LAUNCH_FIRST = {
    "K1": re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel"
                     r"|dx_list_tc_kernel|up_(fwd|dgrad|wgrad)_tc_kernel"),
    "K2": re.compile(r"gather_gemm(_tc)?_kernel<.*true>"),
    "K3": re.compile(r"dw_partial_kernel<.*true>|stem_wide_dw_kernel|dw_list_tc_kernel"),
    "L": re.compile(r"dw_list_count_kernel"),
}
UP = re.compile(r"up_(fwd|dgrad|wgrad)_tc_kernel")
# the readings' kinds that round the reference's sparse convs, by precision
PRECISIONS = {"control": "fp8", "bf16": "bf16"}


# ------------------------------------------------------------------ rooms
def _patch(origin, u, v, n: int):
    """About n vertices on a grid spanning origin + [0, 1] u + [0, 1] v."""
    lu, lv = np.linalg.norm(u), np.linalg.norm(v)
    nu = max(2, int(round((n * lu / lv) ** 0.5)))
    nv = max(2, int(n // nu))
    a, b = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    return origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v


def make_room(rng: np.random.Generator, rooms: dict) -> Dict[str, np.ndarray]:
    """One room (``data/synthetic_scans.make_scan``'s, without faces):
    ``xyz`` [N, 3] metres, ``rgb`` [N, 3] 0-255, ``sem`` nyu40 ids (0: no
    class), ``ins`` instance ids (1.., 0: none)."""
    lo, hi = rooms["points"]
    n = int(round(math.exp(rng.uniform(math.log(lo), math.log(hi)))))
    side = rng.uniform(*rooms["side_m"], size=2)
    room = np.array([side[0], side[1], rooms["height_m"]])
    n_inst = int(rng.integers(rooms["instances"][0], rooms["instances"][1] + 1))
    n_box = n_inst - 5
    budget = n - int(ISOLATED * n)
    surfaces = [(np.zeros(3), np.array([room[0], 0, 0]), np.array([0, room[1], 0]),
                 0.2 * budget, 0, FLOOR)]
    corners = ((0, 0), (room[0], 0), (room[0], room[1]), (0, room[1]), (0, 0))
    for w in range(4):
        a, b = np.array([*corners[w], 0.0]), np.array([*corners[w + 1], 0.0])
        surfaces.append((a, b - a, np.array([0, 0, room[2]]), 0.05 * budget, 1 + w, WALL))
    kinds = rng.integers(len(FURNITURE), size=n_box)
    for k in range(n_box):
        size = rng.uniform([0.3, 0.3, 0.3], [1.6, 1.2, 1.5])
        base = np.append(rng.uniform(0.2, room[:2] - size[:2] - 0.2), 0.0)
        ex, ey, ez = np.diag(size)
        share = 0.6 * budget / n_box / 5
        for origin, u, v in ((base + ez, ex, ey), (base, ex, ez), (base + ey, ex, ez),
                             (base, ey, ez), (base + ex, ey, ez)):
            surfaces.append((origin, u, v, share, 5 + k, FURNITURE[kinds[k]]))
    xyz, ins, sem = [], [], []
    for origin, u, v, count, obj, cls in surfaces:
        pts = _patch(origin, u, v, count)
        xyz.append(pts)
        ins.append(np.full(len(pts), obj + 1))
        sem.append(np.full(len(pts), cls))
    extra = n - sum(len(p) for p in xyz)
    xyz.append(rng.uniform([0, 0, 0], room, size=(max(extra, 0), 3)))
    ins.append(np.zeros(max(extra, 0), np.int64))
    sem.append(np.zeros(max(extra, 0), np.int64))
    xyz, ins, sem = np.concatenate(xyz)[:n], np.concatenate(ins)[:n], np.concatenate(sem)[:n]
    xyz = xyz + rng.normal(0, 0.002, size=xyz.shape)  # a scan's noise
    unlabeled = rng.random(n) < rooms["unlabeled"]
    sem, ins = np.where(unlabeled, 0, sem), np.where(unlabeled, 0, ins)
    colors = rng.integers(40, 216, size=(n_inst + 1, 3))
    rgb = np.clip(colors[ins] + rng.integers(-30, 31, size=(n, 3)), 0, 255)
    return {"xyz": xyz.astype(np.float32), "rgb": rgb.astype(np.uint8), "sem": sem,
            "ins": ins}


def sizes(traffic: dict, rehearse: bool) -> dict:
    """The traffic's sizes: its own, or its ``rehearse`` key's."""
    return {**traffic, **traffic["rehearse"]} if rehearse else traffic


def make_pool(seed: int, traffic: dict) -> List[List[dict]]:
    rng = np.random.default_rng(seed)
    return [[make_room(rng, traffic["rooms"]) for _ in range(int(traffic["batch"]))]
            for _ in range(int(traffic["pool_batches"]))]


# ---------------------------------------------------------------- program
def level_spec(values: dict, traffic: dict):
    """The cell's ``PGSpec``: the configuration's capacities, or the
    traffic's where it gives its own (the rehearsal's)."""
    from instancerefer_tpu_torch.data.pointgroup import PGSpec

    caps = traffic.get("level_caps", values["level_caps"])
    return PGSpec(tuple(int(c) for c in caps), int(traffic.get("point_cap", values["point_cap"])),
                  float(values["scale"]), tuple(values["full_scale"]), int(values["max_npoint"]))


def host_batches(pool, spec) -> List[Dict[str, np.ndarray]]:
    """Each batch of rooms padded to ``spec`` and collated, the rooms on
    host threads."""
    from concurrent.futures import ThreadPoolExecutor

    from instancerefer_tpu_torch.data import pointgroup as data

    def pad(room):
        return data.pad_sample(data.scene_arrays(room["xyz"], room["rgb"], room["sem"],
                                                 room["ins"]), spec)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        return [data.collate(list(ex.map(pad, rooms)), spec) for rooms in pool]


def make_system(values: dict, state: Dict[str, torch.Tensor], spec, dev):
    """The program as PointGroup's train CLI holds it: the model with the
    weights loaded, Adam, the step graphs (``PointGroupTask``), in
    ``benchmark.program.System``'s form."""
    from instancerefer_tpu_torch.models.pointgroup import PointGroup
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.pointgroup import PointGroupTask
    from instancerefer_tpu_torch.train.solver import make_optimizer
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    set_compute_dtype(values["compute_dtype"])
    model = PointGroup(6, values["m"], values["num_levels"], values["block_reps"],
                       values["sem_classes"], values["bn_eps"]).to(dev)
    model.load_state_dict(state)
    optimizer = make_optimizer(model.parameters(), values["lr"], values["wd"])
    dummy = torch.zeros((), device=dev)  # PointGroup reads no mean sizes
    graphs = StepGraphs(model, optimizer, dummy, task=PointGroupTask(),
                        new_graph=None if dev.type == "cuda" else program.EagerGraph)
    return program.System(types.SimpleNamespace(batch_spec=lambda: spec), model, optimizer,
                          graphs, dummy, 0.1)


def launch_counts():
    """(K1 with the inverse convs', -, K2, K3, -, the list pass): the places
    ``trace.counted`` reads."""
    from instancerefer_tpu_torch.train.step_graph import launch_counts as counts
    from instancerefer_tpu_torch.ops.up_conv import up_conv

    c = counts()
    return (c[0] + up_conv.launches, 0, c[2], c[3], 0, c[5])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cfg(values: dict) -> dict:
    return {k: values[k] for k in ("m", "num_levels", "block_reps", "sem_classes", "bn_eps",
                                   "lr", "wd")}


def _prepared(pool, values, dev) -> List[dict]:
    return [ref_pg.prepare([{k: torch.from_numpy(np.asarray(v)) for k, v in r.items()}
                            for r in rooms], float(values["scale"]), int(values["num_levels"]),
                           dev) for rooms in pool]


def caps_exceeded(prepared: List[dict], spec) -> float:
    """Rows and points the capacities would cut, by the reference's count."""
    cut = 0
    for p in prepared:
        for rows in p["rows_per_scene"]:
            cut += sum(max(0, r - c) for r, c in zip(rows, spec.level_caps))
        cut += sum(max(0, n - spec.point_cap) for n in p["points"])
    return float(cut)


def run(ctx) -> Dict[str, object]:
    # the program's PointGroup first: a program without it fails here, at once
    from instancerefer_tpu_torch.data import pointgroup as _pg_data  # noqa: F401
    from instancerefer_tpu_torch.models import pointgroup as _pg_model  # noqa: F401

    dev, log, values = ctx.device, ctx.log, ctx.config
    traffic = sizes(ctx.traffic, dev.type == "cpu")
    if dev.type == "cuda":
        t = time.perf_counter()
        program.build_kernels()
        log(f"kernels ready in {time.perf_counter() - t:.1f} s")
    pool = make_pool(ctx.seed, traffic)
    spec = level_spec(values, traffic)
    t = time.perf_counter()
    host = host_batches(pool, spec)
    staged = [{k: v.to(dev) for k, v in spec.stage(b).items()} for b in host]
    rows = [[int((b[f"pg_owner_{s}"] >= 0).sum()) for s in range(spec.num_stages)] for b in host]
    log(f"{len(staged)} batches of {traffic['batch']} rooms built and staged in "
        f"{time.perf_counter() - t:.1f} s; valid rows a level {rows}; points "
        f"{[int(b['point_mask'].sum()) for b in host]}")
    state = ref_pg.init_state(ref_pg.PointGroup(6, values["m"], values["num_levels"],
                                                values["block_reps"], values["sem_classes"],
                                                values["bn_eps"]), ctx.seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = make_system(values, state, spec, dev)
    first: Dict[str, object] = {"losses": []}
    for j, batch in enumerate(staged):
        metrics, _ = system.step(batch, "train")
        if j < CHECKED:
            first["losses"].append(metrics["loss"])
            if j == 0:
                first["first_grad"], first["stats1"] = system.first_grads(), system.stats()
            if j == min(CHECKED, len(staged)) - 1:
                first["params"], first["stats"] = system.params(), system.stats()
    replays = _replays(system, staged)
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    log(f"set-up {setup_s:.2f} s ({system.graphs.captures} captures)")

    steps = [0] * len(staged)
    i = failed = 0
    _sync(dev)
    start = time.perf_counter()
    while True:
        j = i % len(staged)
        metrics, _ = system.step(staged[j], "train")
        steps[j] += 1
        i += 1
        failed += not math.isfinite(metrics["loss"])
        if time.perf_counter() - start >= ctx.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    log(f"window {window_s:.3f} s: {i} steps")
    record = {"phase": "train", "driver": "resident", "model": "pointgroup",
              "batch": int(traffic["batch"]), "setup_s": setup_s, "window_s": window_s,
              "steps": i, "failed": failed, "scenes": i * int(traffic["batch"]),
              "memory_peak_bytes": peak, "valid_rows": rows}
    if ctx.trace:
        record["profile"] = _profile(system, staged, i / window_s, ctx)

    del system, staged
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    prepared = _prepared(pool, values, dev)
    cfg = _cfg(values)
    ref = ref_pg.train_steps(state, prepared[:CHECKED], cfg)
    numbers, at = check.train_numbers(first, state, ref)
    log(f"worst leaves: {at}; left out as nought but round-off: {check.small_leaves(ref)}")
    del ref
    refs = [ref_pg.step_from(before, prepared[j], cfg, dev)
            for j, before in zip(replays["batches"], replays["befores"])]
    numbers.update(check.replay_numbers(replays["befores"], replays["steps"], refs, log))
    numbers["caps_exceeded"] = caps_exceeded(prepared, spec)
    record["numbers"] = numbers
    log(f"reference check in {time.perf_counter() - t:.1f} s")

    if ctx.trace:
        shapes = [counts_pointgroup.conv_shapes(p, values["m"], values["num_levels"],
                                                values["block_reps"]) for p in prepared]
        record["flops"] = sum(n * counts_pointgroup.step_flops(sh, sum(p["points"]))
                              for n, sh, p in zip(steps, shapes, prepared))
        prof = record["profile"]
        per = prof.pop("steps_per_batch")
        bounds = [counts_pointgroup.launch_bounds(sh) for sh in shapes]
        prof["bound_s"] = sum(n * sum(b for _, _, b in bl) / 1e3 for n, bl in zip(per, bounds))
        prof["up_bound_s"] = sum(n * sum(b for _, up, b in bl if up) / 1e3
                                 for n, bl in zip(per, bounds))
        prof["up_s"] = sum(s for name, s in prof["kernel_s"].items() if UP.search(name))
    return record


def _profile(system, staged, steps_s: float, ctx) -> dict:
    """Whole passes over the pool under the profiler, at least PROFILE_S."""
    passes = max(1, int(PROFILE_S * steps_s / len(staged)) + 1)

    def go(ranges):
        for _ in range(passes):
            for batch in staged:
                system.step(batch, "train", ranges)

    prof = trace.profile(go, launch_counts, LAUNCH_FIRST, ctx.log)
    prof["steps"] = passes * len(staged)
    prof["steps_per_batch"] = [passes] * len(staged)
    return prof


# ------------------------------------------------------- offline tools
def fit_caps(traffic: dict, values: dict, n: int, seed: int) -> dict:
    """Each level's rows in ``n`` rooms drawn as the traffic draws them, and
    the capacities fitted: the largest seen with a tenth more, rounded up to
    64 rows (the kernels' row tile); level 0 takes max_npoint, which no
    room's voxels pass."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seen = []
    for _ in range(n):
        room = make_room(rng, traffic["rooms"])
        p = ref_pg.prepare([{k: torch.from_numpy(np.asarray(v)) for k, v in room.items()}],
                           float(values["scale"]), int(values["num_levels"]), dev)
        seen.append(p["rows"])
    seen = np.array(seen)
    top = seen.max(0)
    caps = [-(-int(values["max_npoint"]) // 64) * 64] + [-(-int(t * 1.1) // 64) * 64
                                                         for t in top[1:]]
    return {"rooms": n, "largest": top.tolist(), "median": np.median(seen, 0).tolist(),
            "caps": caps}


def readings(seed: int, values: dict, traffic: dict, dev, kinds) -> dict:
    """{kind: numbers} of the reference in the program's place: ``control``
    (its sparse convs in float8 e4m3), ``bf16`` (in bfloat16, the program's
    storage: the witness) and the faults."""
    pool = make_pool(seed, traffic)
    prepared = _prepared(pool, values, dev)
    state = ref_pg.init_state(ref_pg.PointGroup(6, values["m"], values["num_levels"],
                                                values["block_reps"], values["sem_classes"],
                                                values["bn_eps"]), seed, dev)
    cfg = _cfg(values)
    ref = ref_pg.train_steps(state, prepared[:CHECKED], cfg)
    befores = [ref_pg.train_steps(state, prepared, cfg, keep=True)["snapshot"]]
    sound = []
    for p in prepared:
        step = ref_pg.step_from(befores[-1], p, cfg, dev, keep=True)
        befores.append(step.pop("snapshot"))
        sound.append(step)
    befores.pop()
    out = {}
    for kind in kinds:
        how = {"precision": PRECISIONS[kind]} if kind in PRECISIONS else {"fault": kind}
        got = ref_pg.train_steps(state, prepared[:CHECKED], cfg, **how)
        out[kind], at = check.train_numbers(got, state, ref)
        out[kind].update(check.replay_numbers(
            befores, [ref_pg.step_from(b, p, cfg, dev, **how) for b, p in zip(befores, prepared)],
            sound))
        out[kind]["at"] = at
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="pointgroup-train-resident")
    ap.add_argument("--fit-caps", action="store_true")
    ap.add_argument("--rooms", type=int, default=400)
    ap.add_argument("--readings", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="the reference with its sparse convs in bfloat16 too")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from benchmark import run as bench_run

    _, values, traffic, _, _, _ = bench_run.cell_data(bench_run.ROOT, args.workload)
    if args.fit_caps:
        print(json.dumps(fit_caps(traffic, values, args.rooms, 12345)), flush=True)
    if args.readings:
        dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
        kinds = (["control"] + (["bf16"] if args.witness else [])
                 + (["frozen", "half", "altered"] if args.faults else []))
        for seed in args.seeds:
            for kind, numbers in readings(seed, values, traffic, dev, kinds).items():
                print(json.dumps({"seed": seed, "kind": kind, "numbers": numbers}), flush=True)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
