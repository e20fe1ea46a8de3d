"""The odds that a traffic's scenes overflow the instance capacities, the
rows a sample holds at each stage of the candidates' pyramid:

    python3 -m benchmark.caps --traffic resident-train-b64 [--candidates 200000]

A sample's rows at a stage are the sum of its candidates' voxels there.
Its candidates are the ``num_candidates`` instances of the described class
and each other instance whose class is drawn the same (1 in
``scenes.NUM_CLASSES``), at most ``max_candidates``.  The tool draws
``--candidates`` instances as ``scenes.make_scene`` does (``box_points``,
then the 1024 points resampled from them), counts each one's voxels at
``voxel_size_ap`` and each stride 2^s, and sums them over the candidate
count's law, which gives P(a sample's rows > cap) at each stage.  It
prints those odds and, a stage, the smallest multiple of 64 rows (the
sparse kernels' row tile) under ``--odds`` a sample.  On the CPU, in a
minute.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from benchmark import scenes

HERE = os.path.dirname(os.path.abspath(__file__))
ROW_TILE = 64


def candidate_rows(n: int, traffic: dict, voxel: float, stages: int, seed: int) -> np.ndarray:
    """[n, stages] voxels of ``n`` instances drawn as the traffic draws them."""
    rng = np.random.default_rng(seed)
    sc = traffic["scene"]
    out = np.zeros((n, stages), np.int64)
    for i in range(n):
        pts = scenes.random_sampling(
            scenes.box_points(rng, sc["scene_extent"], sc["points_per_instance"]), 1024, rng)
        c = np.floor(pts / voxel).astype(np.int64)
        for s in range(stages):
            q = c >> s
            out[i, s] = len(np.unique((q[:, 0] << 40) + (q[:, 1] << 20) + q[:, 2]))
    return out


def candidate_law(traffic: dict, max_candidates: int) -> dict:
    """P(a sample has k candidates), k capped at ``max_candidates``."""
    sc = traffic["scene"]
    others, p = sc["num_instances"] - sc["num_candidates"], 1.0 / scenes.NUM_CLASSES
    law: dict = {}
    for j in range(others + 1):
        k = min(sc["num_candidates"] + j, max_candidates)
        law[k] = law.get(k, 0.0) + math.comb(others, j) * p ** j * (1 - p) ** (others - j)
    return law


def overflow_odds(rows: np.ndarray, law: dict) -> np.ndarray:
    """P(a sample's rows > x) for x = 0, 1, ...: the candidates' rows
    summed over ``law``."""
    pmf = np.bincount(rows).astype(float) / len(rows)
    top = max(law) * (len(pmf) - 1) + 2
    odds, conv = np.zeros(top), np.array([1.0])
    for k in range(1, max(law) + 1):
        conv = np.convolve(conv, pmf)
        if k in law:
            above = conv[::-1].cumsum()[::-1]  # P(sum >= x)
            odds[:len(above) - 1] += law[k] * above[1:]
    return odds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--config", default="instancerefer-scanrefer-xyzrgbh")
    ap.add_argument("--candidates", type=int, default=200000)
    ap.add_argument("--odds", type=float, default=1e-9)
    ap.add_argument("--seed", type=int, default=12345)
    args = ap.parse_args(argv)
    with open(os.path.join(HERE, "traffic", f"{args.traffic}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        values = json.load(f)
    stages = len(values["inst_caps"])
    rows = candidate_rows(args.candidates, traffic, float(values["voxel_size_ap"]), stages,
                          args.seed)
    law = candidate_law(traffic, int(values["max_candidates"]))
    print(json.dumps({"candidates": args.candidates, "law": law,
                      "candidate_max": rows.max(0).tolist()}))
    for s in range(stages):
        odds = overflow_odds(rows[:, s], law)
        caps = range(ROW_TILE, len(odds) + ROW_TILE, ROW_TILE)
        at = {c: float(odds[c]) if c < len(odds) else 0.0 for c in caps}
        fit = next(c for c, o in at.items() if o < args.odds)
        cap = int(values["inst_caps"][s])
        print(json.dumps({"stage": s, "cap": cap,
                          "odds_at_cap": float(odds[cap]) if cap < len(odds) else 0.0, "fits": fit,
                          "odds": {c: o for c, o in at.items() if o > 1e-12}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
