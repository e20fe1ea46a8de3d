"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference (``reference/``), each beside its limit from
``limits/<cell>.json``.

A gap of a leaf is | |x| - |x_ref| | / max(|x_ref|, the median leaf's
|x_ref|).  Leaves whose reference gradient is under a thousandth of the
median leaf's (a bias that a BatchNorm follows: nought but round-off,
which Adam turns into steps of lr) count in neither gradient nor change.

Train, the start (the first three steps of the object the window then
drives, from the benchmark's weights; each key's first step runs eagerly
before its capture):
* ``loss_gap``: |loss - reference| / |reference| of the first step;
* ``grad_gap``: the first gradient as Adam took it (from its state after
  one step), the median leaf's gap: the worst leaves are the stems'
  BatchNorm scales and shifts, sums over ~1M rows of a bf16 cotangent that
  cancel, and read as far apart as the control does;
* ``change_gap_worst``: the parameters' change over the three steps, the
  worst leaf's gap;
* ``stats_gap``: the BatchNorms' running means and variances' change over
  the first step, the median buffer's gap.
Readings beside them, not compared: the gradient's and the statistics'
worst leaf, the change's median leaf, the statistics after three steps and
the loss over all three; and the look at the worst change leaf: the share
of its elements that moved the other way from the reference's
(``change_flip_share``), their median |gradient| over the leaf's
(``change_flip_grad``), and the leaf's gap without them
(``change_gap_worst_unflipped``).

Train, the graph replays (a whole pass over the pool once every key is
captured, each step against the reference's one step from the state the
program started it from, taken whole with Adam's: ``replay_numbers``),
each the largest over the steps:
* ``replay_loss_gap``: the step's loss;
* ``replay_grad_gap``: the step's gradient as Adam took it (from its
  first moment before and after), the median leaf's gap;
* ``replay_change_gap``: the step's change of the parameters, the worst
  leaf's gap;
* ``replay_stats_gap``: the step's change of the running statistics, the
  median buffer's gap.

Eval (every step of the window, each against the reference's forward of its
batch):
* ``loss_gap``: the largest |loss - reference| / |reference|;
* ``score_gap``: the largest |score - reference| of a candidate's summed
  score (attribute + relation + scene);
* ``choice_gap``: the widest gap by which the reference's score of the
  candidate the program picked lies below the reference's best (samples
  with two candidates or more).

Both: ``caps_exceeded``, what the configuration's capacities would have cut
from the generated batches (limit 0: such traffic is not the one the
configuration runs).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

SMALL_LEAF = 1e-3  # a leaf under this share of the median leaf's gradient


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              names) -> Dict[str, float]:
    """Per leaf of ``names``: | |got| - |want| | / max(|want|, the median
    leaf's |want|)."""
    norms = {n: float(want[n].double().norm()) for n in names}
    floor = _median(list(norms.values()))
    return {n: _worse(0.0, abs(float(got[n].double().norm()) - norms[n])
                      / max(norms[n], floor, 1e-30)) for n in names}


def train_numbers(program: dict, init: Dict[str, torch.Tensor], ref: dict):
    """The train numbers of the program's first steps (``losses``, the
    first step's gradient ``first_grad``, ``stats1`` after it, ``params``
    and ``stats`` after the last) against the reference's
    (``reference.steps.train``) from ``init``: the compared ones (see the
    module's note) and, as readings beside them, each gap's worst leaf and
    the loss's over every step.  Also the leaf each worst reading is at."""
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["losses"],
                                                                  ref["losses"])]
    small = set(small_leaves(ref))
    leaves = [n for n in ref["first_grad"] if n not in small]

    def change(state, start, names):
        return {n: state[n].double() - start[n].double() for n in names}

    stat_names = list(ref["stats"])
    per = {
        "grad": leaf_gaps(program["first_grad"], ref["first_grad"], leaves),
        "change": leaf_gaps(change(program["params"], init, leaves),
                            change(ref["params"], init, leaves), leaves),
        "stats": leaf_gaps(change(program["stats1"], init, stat_names),
                           change(ref["stats1"], init, stat_names), stat_names),
        "stats3": leaf_gaps(change(program["stats"], init, stat_names),
                            change(ref["stats"], init, stat_names), stat_names),
    }
    numbers = {"loss_gap": _worse(0.0, loss_gaps[0]),
               "loss_gap_any_step": max(_worse(0.0, g) for g in loss_gaps)}
    for kind, gaps in per.items():
        if kind != "stats3":
            numbers[f"{kind}_gap"] = _median(list(gaps.values()))
        numbers[f"{kind}_gap_worst"] = max(gaps.values())
    at = {kind: max(gaps, key=gaps.get) for kind, gaps in per.items()}
    worst = at["change"]
    numbers.update(_flips(program["params"][worst].double() - init[worst].double(),
                          ref["params"][worst].double() - init[worst].double(),
                          ref["first_grad"][worst].double(),
                          _median([float(ref["params"][n].double().sub(init[n].double()).norm())
                                   for n in leaves])))
    return numbers, at


def _flips(got: torch.Tensor, want: torch.Tensor, grad: torch.Tensor, floor: float) -> dict:
    """The look at a leaf's change: the share of its elements that moved
    the other way from the reference's, their median |gradient| over the
    leaf's, and the leaf's gap over the other elements alone."""
    got, want, grad = got.flatten().cpu(), want.flatten().cpu(), grad.flatten().cpu()
    flip = torch.sign(got) != torch.sign(want)
    keep = ~flip
    denom = max(float(want.norm()), floor, 1e-30)
    med = float(grad.abs().median())
    return {"change_flip_share": float(flip.double().mean()),
            "change_flip_grad": float(grad[flip].abs().median()) / max(med, 1e-30)
            if bool(flip.any()) else 0.0,
            "change_gap_worst_unflipped": abs(float(got[keep].norm())
                                              - float(want[keep].norm())) / denom}


def replay_numbers(befores: List[dict], program: List[dict], refs: List[dict],
                   log=None) -> dict:
    """The numbers of the graph replays (see the module's note): step k of
    the program started from ``befores[k]`` (a whole state,
    ``reference.steps.snapshot``'s form) and gave ``program[k]`` (its
    ``loss``, ``grad``, ``params`` and ``stats`` after), the reference's
    one step from the same state ``refs[k]`` (``reference.steps.step_from``).
    Beside the compared ones: the gradient's worst leaf, the change's median
    leaf and the statistics' worst buffer, each the largest over the steps;
    ``log`` takes a line on each step."""
    out = {k: 0.0 for k in ("replay_loss_gap", "replay_grad_gap", "replay_change_gap",
                            "replay_stats_gap", "replay_grad_gap_worst",
                            "replay_change_gap_median", "replay_stats_gap_worst")}
    for before, got, want in zip(befores, program, refs):
        start = before["state"]
        small = set(small_leaves({"first_grad": want["grad"]}))
        leaves = [n for n in want["grad"] if n not in small]

        def change(after, names):
            return {n: after[n].double().cpu() - start[n].double().cpu() for n in names}

        grad = leaf_gaps(got["grad"], want["grad"], leaves)
        moved = leaf_gaps(change(got["params"], leaves), change(want["params"], leaves), leaves)
        names = list(want["stats"])
        stats = leaf_gaps(change(got["stats"], names), change(want["stats"], names), names)
        step = {"replay_loss_gap": abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-30),
                "replay_grad_gap": _median(list(grad.values())),
                "replay_change_gap": max(moved.values()),
                "replay_stats_gap": _median(list(stats.values())),
                "replay_grad_gap_worst": max(grad.values()),
                "replay_change_gap_median": _median(list(moved.values())),
                "replay_stats_gap_worst": max(stats.values())}
        out = {k: _worse(v, step[k]) for k, v in out.items()}
        if log:
            dot = sum(float((got["grad"][n].double().cpu() * want["grad"][n].double()).sum())
                      for n in leaves)
            size = math.sqrt(sum(float(got["grad"][n].double().norm()) ** 2 for n in leaves)
                             * sum(float(want["grad"][n].double().norm()) ** 2 for n in leaves))
            log(f"replay step: loss {got['loss']!r} reference {want['loss']!r}; "
                + ", ".join(f"{k} {v:.3g}" for k, v in step.items())
                + f"; the gradients' cosine {dot / max(size, 1e-300):.9f}; leaves with a "
                f"gradient gap over 5e-3: {sum(v > 5e-3 for v in grad.values())} of {len(grad)}; "
                f"worst gradient {max(grad, key=grad.get)}, change {max(moved, key=moved.get)}")
    return out


def small_leaves(ref: dict) -> List[str]:
    """The leaves whose reference gradient is under ``SMALL_LEAF`` of the
    median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in ref["first_grad"].items()}
    med = _median(list(norms.values()))
    return sorted(n for n, v in norms.items() if v < SMALL_LEAF * med)


def eval_numbers(answers: List[tuple], refs: List[dict]) -> Dict[str, float]:
    """``answers``: (pool batch, loss, summed score [B, C], candidate mask
    [B, C]) of each step; ``refs``: the reference's ``evaluate`` of each
    pool batch.  The answers of one pool batch are held against its
    reference together."""
    loss_gap = score_gap = choice_gap = 0.0
    for j, want in enumerate(refs):
        mine = [a for a in answers if a[0] == j]
        if not mine:
            continue
        losses = torch.tensor([a[1] for a in mine], dtype=torch.float64)
        loss_gap = _worse(loss_gap, float(((losses - want["loss"]).abs()
                                           / max(abs(want["loss"]), 1e-30)).max()))
        score = torch.stack([a[2] for a in mine]).float()  # [n, B, C]
        cand = torch.stack([a[3] for a in mine])
        ref = want["score"].to(score.device).expand_as(score)
        diff = torch.where(cand, (score - ref).abs(), 0.0)
        score_gap = _worse(score_gap, float(diff.max()))
        masked = torch.where(cand, ref, float("-inf"))
        pick = torch.where(cand, score, float("-inf")).argmax(-1, keepdim=True)
        gap = masked.amax(-1) - masked.gather(-1, pick)[..., 0]
        multi = cand.sum(-1) >= 2
        if bool(multi.any()):
            choice_gap = _worse(choice_gap, float(gap[multi].max()))
    return {"loss_gap": loss_gap, "score_gap": score_gap, "choice_gap": choice_gap}


def _worse(a: float, b: float) -> float:
    """The larger of two readings, where a reading that is not finite is
    infinite (``max`` would drop a NaN)."""
    return max(a, b) if math.isfinite(b) else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number that is not finite is not)."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
