"""Resident traffic: a pool of batches built on the host in set-up and
staged on the device, then a closed loop of steps over it, as the solver
runs a step: ``StepGraphs.load`` of the next pool batch into its graph's
inputs, the train or eval step, the metrics to the host.  The host feed is
bypassed.

Set-up runs one pass over the pool: every language grid's first step runs
eagerly and is captured, so nothing compiles or captures in the window.
In train the first three of those steps, on three different batches,
from the benchmark's weights, are the start the check follows; then a
second pass, every step a graph replay, is the replays it follows, each
step from the whole state (Adam's with it) taken before it.  The window
then drives the same object until ``--seconds`` have passed and ends with
a synchronize; its rate is all the scenes of the steps it finished over
all its time.  In eval every answer of the window is kept and compared.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

from benchmark import check, counts, program, scenes, trace
from benchmark.reference import batch as ref_batch
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

CHECKED = 3  # train: the start's steps the reference follows
PROFILE_S = 0.5  # the traced window's least length


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> Dict[str, object]:
    traffic, values, dev, log = ctx.traffic, ctx.config, ctx.device, ctx.log
    phase = traffic["phase"]
    if dev.type == "cuda":
        t = time.perf_counter()
        program.build_kernels()
        log(f"kernels ready in {time.perf_counter() - t:.1f} s")
    pool = scenes.make_pool(ctx.seed, traffic, bool(values["use_multiview"]))
    cfg = program.config(values)
    t = time.perf_counter()
    staged = [program.stage(b, cfg, dev)
              for b in program.batches(pool, cfg, program.host_threads())]
    log(f"{len(staged)} batches of {traffic['batch']} built and staged in "
        f"{time.perf_counter() - t:.1f} s; language grids "
        f"{[int(s['lang_feat'].shape[1]) for s in staged]}")
    state, ref_s = make_state(values, phase, pool, ctx.seed, dev)
    if dev.type == "cuda":  # the peak read after the window is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = program.system(cfg, state, scenes.MEAN_SIZE, phase, dev, float(values["dropout"]))
    first: Dict[str, object] = {"losses": []}
    for j, batch in enumerate(staged):
        host, _ = system.step(batch, phase)
        if phase == "train" and j < CHECKED:
            first["losses"].append(host["loss"])
            if j == 0:
                first["first_grad"], first["stats1"] = system.first_grads(), system.stats()
            if j == min(CHECKED, len(staged)) - 1:
                first["params"], first["stats"] = system.params(), system.stats()
    replays = _replays(system, staged) if phase == "train" else None
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0 - ref_s
    log(f"set-up {setup_s:.2f} s ({system.graphs.captures} captures"
        + (f"; {ref_s:.2f} s of the reference's statistics left out)" if ref_s else ")"))

    steps = [0] * len(staged)
    answers = []
    i = failed = 0
    _sync(dev)
    start = time.perf_counter()
    while True:
        j = i % len(staged)
        host, out = system.step(staged[j], phase)
        steps[j] += 1
        i += 1
        failed += not math.isfinite(host["loss"])
        if phase == "eval":
            answers.append((j, host["loss"], out["attribute_scores"], out["relation_scores"],
                            out["scene_scores"], out["cand_mask"]))
        if time.perf_counter() - start >= ctx.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    log(f"window {window_s:.3f} s: {i} steps")
    record = {"phase": phase, "driver": "resident", "batch": int(traffic["batch"]),
              "setup_s": setup_s, "window_s": window_s, "steps": i, "failed": failed,
              "scenes": i * int(traffic["batch"]), "memory_peak_bytes": peak}

    if ctx.trace:
        record["profile"] = _profile(system, staged, phase, i / window_s, ctx)

    # the program's state is freed before the reference runs
    del system, staged, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    prepared = [ref_batch.prepare(s, values, dev) for s in pool]
    ms = torch.tensor(scenes.MEAN_SIZE, dtype=torch.float32, device=dev)
    if phase == "train":
        n = len(first["losses"])
        ref = ref_steps.train(state, prepared[:n], values, ms, program_momentum(values))
        numbers, at = check.train_numbers(first, state, ref)
        log(f"worst leaves: {at}; left out as nought but round-off: {check.small_leaves(ref)}")
        del ref
        refs = [ref_steps.step_from(before, prepared[j], values, ms, program_momentum(values))
                for j, before in zip(replays["batches"], replays["befores"])]
        numbers.update(check.replay_numbers(replays["befores"], replays["steps"], refs, log))
    else:
        refs = [ref_steps.evaluate(state, p, values, ms) for p in prepared]
        numbers = check.eval_numbers(
            [(j, loss, a + r + s, c) for j, loss, a, r, s, c in answers], refs)
    numbers["caps_exceeded"] = float(sum(p["caps_exceeded"] for p in prepared))
    record["numbers"] = numbers
    log(f"reference check in {time.perf_counter() - t:.1f} s")

    if ctx.trace:
        shapes = [ref_batch.conv_shapes(p, ref_batch.feature_dim(values)) for p in prepared]
        record["flops"] = sum(
            n * counts.step_flops(sh, phase, int(traffic["batch"]), int(values["scene_caps"][-1]),
                                  int(values["max_des_len"])) for n, sh in zip(steps, shapes))
        bounds = [sum(b for _, b in counts.launch_bounds(sh, phase)) / 1e3 for sh in shapes]
        prof = record["profile"]
        prof["bound_s"] = sum(bounds[j] * n for j, n in enumerate(prof.pop("steps_per_batch")))
    return record


def make_state(values: dict, phase: str, pool, seed: int, dev):
    """The benchmark's weights from ``seed`` (``reference.model.init_state``);
    for eval, with the running statistics of the pool's first batch
    (``reference.steps.with_batch_statistics``).  Returns (the state, the
    seconds the reference took for the statistics, which set-up leaves
    out)."""
    state = ref_model.init_state(ref_model.InstanceRefer(ref_batch.feature_dim(values),
                                                         values["num_classes"]), seed, dev)
    if phase != "eval":
        return state, 0.0
    _sync(dev)
    t = time.perf_counter()
    state = ref_steps.with_batch_statistics(state, ref_batch.prepare(pool[0], values, dev),
                                            values)
    _sync(dev)
    return state, time.perf_counter() - t


def _replays(system, staged) -> dict:
    """A pass over the pool once every key is captured, each step a graph
    replay: the whole state before each step and after the last, and what
    each step gave (its loss; the gradient Adam took, from the first moment
    before and after; the parameters and statistics after)."""
    beta1 = system.optimizer.param_groups[0]["betas"][0]
    names = [n for n, _ in system.model.named_parameters()]
    captures = system.graphs.captures
    befores, steps = [system.snapshot()], []

    def moment(snap, n):
        a = snap["adam"].get(n)
        return a["exp_avg"].double() if a else torch.zeros_like(snap["state"][n], dtype=torch.float64)

    for batch in staged:
        host, _ = system.step(batch, "train")
        befores.append(system.snapshot())
        before, after = befores[-2], befores[-1]
        steps.append({
            "loss": host["loss"],
            "grad": {n: (moment(after, n) - beta1 * moment(before, n)) / (1 - beta1)
                     for n in names},
            "params": {n: after["state"][n] for n in names},
            "stats": {n: v for n, v in after["state"].items() if "running" in n}})
    if system.graphs.captures != captures:
        raise RuntimeError("a step of the replays' pass captured: the pass is not replays")
    return {"batches": list(range(len(staged))), "befores": befores[:-1], "steps": steps}


def program_momentum(values: dict) -> float:
    """The BatchNorms' momentum of a first epoch (no decay schedule: 0.1)."""
    step, rate = values.get("bn_decay_step"), values.get("bn_decay_rate")
    return max(0.5 * rate ** 0, 0.001) if step and rate else 0.1


def _profile(system, staged, phase: str, steps_s: float, ctx) -> dict:
    """Whole passes over the pool under the profiler, at least
    ``PROFILE_S`` long."""
    from benchmark.metrics._kernel_names import LAUNCH_FIRST

    passes = max(1, int(PROFILE_S * steps_s / len(staged)) + 1)
    per = [passes] * len(staged)

    def run(ranges):
        for _ in range(passes):
            for batch in staged:
                system.step(batch, phase, ranges)

    prof = trace.profile(run, program.launch_counts, LAUNCH_FIRST, ctx.log)
    prof["steps"] = passes * len(staged)
    prof["steps_per_batch"] = per
    return prof
