"""The readings the limits of a cell's check are set from (``limits/``),
on the card at the cell's own size, many seeds in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 11 12 ... \\
        [--program] [--control] [--faults] [--seconds 2]

* ``--program``: the run's own check (``drivers``) with a short window:
  the sound program's numbers, the lower readings;
* ``--control``: the reference put in the program's place with its sparse
  convs in float8 e4m3 under a per-tensor scale, one precision below the
  configuration's bfloat16 (``reference.model.precision_of``): its
  numbers, the upper readings;
* ``--faults``: the reference in the program's place with each fault of
  ``reference.steps.FAULTS`` planted (train: a state left unchanged, half
  of the batch, an altered answer; eval: the last two).

In train each kind reads the start (its first steps from the benchmark's
weights) and the replays (one step a batch of the pool, each from the
state the sound reference reached, taken whole, after a pass over the pool
and the steps before it).

One JSON line a seed and kind on standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, run, scenes
from benchmark.drivers.resident import CHECKED, make_state, program_momentum
from benchmark.reference import batch as ref_batch
from benchmark.reference import steps as ref_steps


def reference_readings(seed: int, values: dict, traffic: dict, dev, kinds) -> dict:
    """{kind: numbers} of the reference in the program's place."""
    phase = traffic["phase"]
    pool = scenes.make_pool(seed, traffic, bool(values["use_multiview"]))
    state, _ = make_state(values, phase, pool, seed, dev)
    prepared = [ref_batch.prepare(s, values, dev) for s in pool]
    ms = torch.tensor(scenes.MEAN_SIZE, dtype=torch.float32, device=dev)
    out = {}
    if phase == "train":
        m = program_momentum(values)
        ref = ref_steps.train(state, prepared[:CHECKED], values, ms, m)
        # the replays' pass from the state after the set-up's pass, both the
        # reference's own
        befores = [ref_steps.train(state, prepared, values, ms, m, keep=True)["snapshot"]]
        sound = []
        for p in prepared:
            step = ref_steps.step_from(befores[-1], p, values, ms, m, keep=True)
            befores.append(step.pop("snapshot"))
            sound.append(step)
        befores.pop()
        for kind in kinds:
            how = {"precision": "fp8"} if kind == "control" else {"fault": kind}
            got = ref_steps.train(state, prepared[:CHECKED], values, ms, m, **how)
            out[kind], at = check.train_numbers(got, state, ref)
            out[kind].update(check.replay_numbers(
                befores, [ref_steps.step_from(b, p, values, ms, m, **how)
                          for b, p in zip(befores, prepared)], sound))
            out[kind]["at"] = at
    else:
        refs = [ref_steps.evaluate(state, p, values, ms) for p in prepared]
        for kind in kinds:
            answers = []
            for j, p in enumerate(prepared):
                got = ref_steps.evaluate(state, p, values, ms,
                                         precision="fp8" if kind == "control" else None,
                                         fault=None if kind == "control" else kind)
                answers.append((j, got["loss"], got["score"], p["cand_mask"]))
            out[kind] = check.eval_numbers(answers, refs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rehearse", action="store_true", help="on the CPU at the rehearsal's size")
    args = ap.parse_args(argv)
    cell, values, traffic, _, _, _ = run.cell_data(run.ROOT, args.workload, args.rehearse)
    dev = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    kinds = (["control"] if args.control else []) + (
        [f for f in ref_steps.FAULTS if traffic["phase"] == "train" or f != "frozen"]
        if args.faults else [])
    for seed in args.seeds:
        if args.program:
            driver = __import__(f"benchmark.drivers.{traffic['driver']}", fromlist=["run"])
            ctx = run.Context(cell, values, traffic, seed, args.seconds, False, dev,
                              time.perf_counter(), run.log)
            record = driver.run(ctx)
            print(json.dumps({"cell": args.workload, "seed": seed, "kind": "program",
                              "numbers": record["numbers"], "steps": record["steps"]}),
                  flush=True)
            del record
        if kinds:
            for kind, numbers in reference_readings(seed, values, traffic, dev, kinds).items():
                print(json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                                  "numbers": numbers}), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
