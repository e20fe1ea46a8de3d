"""The port's bench: card time per trained or per scored scene, and the rate
at which the solver's feed keeps the card busy, at the published
configuration on one GPU.  The counterpart of the JAX package's
``bench.py``.

    python -m instancerefer_tpu_torch.scripts.bench --mode {train,eval} [--batch 32]
        [--seed 0] [--iters N] [--fed-iters 30] [--device cuda|cpu]

The configuration (``instancerefer-scanrefer-xyzrgbh``) is
``config/InstanceRefer.yaml``'s model (xyz, rgb and height into the stems,
Cin 7; a bidirectional GRU; k = 8; Adam at its lr and wd; bf16 sparse
convs) with the fitted caps of ``config/band_profile.synthetic.yaml`` and
a language grid of 126 tokens.  Weights are random, from ``--seed``.  The
workload is ``bench.py``'s: synthetic ScanRefer-scale scenes (40 000
points, 12 instances, 4 candidates), one batch of ``--batch`` replayed.
The yaml's own batch is 64; ``--batch`` defaults to 32 as ``bench.py``'s.

Phases, in order:

1. The steps as the solver runs them on one card (``train/step_graph``):
   the key's first batch eagerly (warm-up) and captured, then replays.  The
   first replay against one eager step of a copy of the model and its
   optimizer (dropout drawn from the same seed on both), then ``--iters``
   replays (by default ``ITERS``: a window of seconds), each timed on the
   host clock up to ``torch.cuda.synchronize()``: the median, p90 and
   count; scenes/s is the batch over the median.
2. One window of ``PROFILE_CALLS`` replays under ``torch.profiler``, apart
   from the timed ones (``utils/profiling.device_profile``, retaken until
   its launches agree with the counters): the device's busy ms and idle
   share, K1 / K2 / K3 / split sums, the rest by class (the language
   module's GRU among them), the busiest kernels, the longest idle gaps
   and the idle ms by the span the host was in; peak device memory.  Then
   ``MODULE_STEPS`` eager steps of the same batch under the profiler
   (``utils/profiling.module_split``): the device ms a step by module,
   forward and backward (``profile.modules``).
3. ``--mode eval``: the occupancy curve, eval scenes/s at 10k, 40k and 80k
   points through the same graph (``bench.py``'s batches), each with its
   live-voxel fraction and its capacity overflow: the fitted caps do not
   hold every 80k-point scene, so the curve is a reading, not part of the
   gate.
4. The fed rate: a ScanRefer-layout root written from the seed into a
   temporary directory, ``data/dataset.PaddedLoader`` at the bench's caps
   as the CLIs set it (train: augmentation on, shuffled; eval: the val
   split, the scene-block cache), fed through ``train/solver.Solver._feed``
   (its prefetcher and its graph step): scenes/s over ``--fed-iters``
   iterations after the one that captures, the medians of ``fetch_load``,
   ``fetch_copy``, ``fetch_stage`` and the step a iteration, and the fed
   batches' largest capacity overflow; then the same loader alone for the
   same iterations (``loader_only_scenes_s``: the feed's ceiling with the
   CLIs' build threads) and the host's ``os.cpu_count()``.
5. The host alone: ``pad_sample``'s phase split and ``collate``'s ms
   (``scripts/bench_host_pipeline``), and the batch build's scenes/s with
   the CLIs' worker count (``e2e_scenes_s_1core_host``, ``bench.py``'s
   name).

Utilisation (``eval_mfu`` or ``train_mfu``): the FLOPs these inputs need,
the valid entries of each sparse conv's map x Cin x Cout x 2 plus
``bench.py``'s coarse dense terms (train: 3x the forward), over one step's
median, over 989e12 FLOP/s (the H100's dense bf16 peak at 700 W).
``model_gflop_padded`` is ``bench.py``'s count at the padded capacities,
a count only.

The result is correct (``"correct": true``) only if all of these hold:

- the first replay agrees with the eager step of the copy, from one state:
  train, the loss, every parameter's gradient, the running statistics
  and the parameters after Adam, to the limits ``chip_smoke.py`` phase 12a
  holds a replay to (``compare``); eval, the loss and scores to
  ``SLICE_ATOL`` + ``SLICE_RTOL``, ``ref_acc`` equal;
- every launch of K1, K2 and K3 in that eager step agrees with the
  kernel's plain twin (``ops/sparse``) on the same inputs, to the limits
  of the smoke's kernel phases (``TWIN_TOL``), and the step called each
  wrapper as often as a step launches it (``held_against_twins``);
- every output is finite; the replayed batch, and in eval the fed ones,
  fit their caps (a train epoch's augmentation overflows the fitted caps,
  ROADMAP §3, so the fed train batches' overflow is a reading);
- every sparse conv launched its hand-written kernel: 34 / 16 / 10
  K1 / K2 / K3 launches a train step (K3's list pass in 8 of them), 26 K1
  an eval step (on the CPU, which runs the plain twins, none).

It exits nonzero otherwise.

Without a card it fails unless ``--device cpu`` is given: then every phase
runs eagerly at ``TEST_SPEC`` on scenes its caps hold (the rehearsal), and
every time-derived value is null.  Progress goes to stderr; the last line
of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "config", "InstanceRefer.yaml")
PROFILE = os.path.join(REPO, "config", "band_profile.synthetic.yaml")
CONFIG_NAME = "instancerefer-scanrefer-xyzrgbh"
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
SCENE_KW = dict(num_points=40000, num_instances=12, num_candidates=4)
# the occupancy curve: (points, instances) a scene
OCCUPANCY = ((10000, 6), (40000, 12), (80000, 16))
# the CPU rehearsal: scenes that TEST_SPEC's caps hold
CPU_SCENE_KW = dict(num_points=300, num_instances=5, num_candidates=3, points_per_instance=8,
                    scene_extent=1.5)
CPU_OCCUPANCY = ((150, 4), (300, 5), (400, 5))
CPU_ROOT_KW = dict(num_points=200, points_per_instance=4, extent=1.5)
# ScanRefer has 65-67 descriptions a scene in each split
DESCRIPTIONS_PER_SCENE = 64
# Estimated, not measured: the reference publishes no throughput numbers;
# ~15 scenes/s is an A100 estimate of its host-loop-bound forward
# (``bench.py``).  vs_baseline is ours / this estimate.
A100_REFERENCE_SCENES_PER_SEC = 15.0
PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16, at 700 W
WIDTHS = (32, 64, 128, 128, 128)  # the encoders' channels by stage
PROFILE_CALLS = 5  # replays in the profiled window
MODULE_STEPS = 3  # eager steps in the module split's window
# timed replays by default: a window of 2-4 s on an H100 at B = 64 (a
# train replay takes ~46 ms, an eval replay ~6.5)
ITERS = {"train": 50, "eval": 500}
HOST_REPS = 5  # repeats of each host measurement (medians)
# the launch counters of ``step_graph.LAUNCH_COUNTERS``, and what a step
# launches on a card
COUNTER_NAMES = ("K1", "K1 at the stems", "K2", "K3", "K3 at the stems", "K3's list pass")
LAUNCHES = {"train": (34, 2, 16, 10, 2, 8), "eval": (26, 2, 0, 0, 0, 0)}
# the first replay against the eager step of the copy, from one state
# (chip_smoke.py phase 12a's limits): the train loss to LOSS_RTOL; each
# parameter's gradient in L2 to GRAD_LAYER x the largest gradient norm of
# its layer and all of them to GRAD_ALL; the running statistics to
# STATS_RTOL + 1e-5; after Adam, each parameter within 2.5 lr + 1e-3 |p|
# and all of them within ADAM_MEAN lr on average.  Eval loss and scores to
# |diff| <= SLICE_ATOL + SLICE_RTOL |eager|
LOSS_RTOL, STATS_RTOL, GRAD_LAYER, GRAD_ALL, ADAM_MEAN = 1e-4, 1e-3, 5e-2, 2e-2, 0.25
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-3
# a kernel against its plain twin on the same inputs: a bf16 output rounds
# the same f32 sum, so it may differ by one bf16 ulp: |err| <= 1e-2 x
# max|twin| (chip_smoke.py's KERNEL_TOL); an f32 output differs only in the
# order of its f32 sums, each element by at most a share of the sum of its
# terms' magnitudes (the twin on |inputs|): |err| <= 1e-4 x that sum.  A dW
# sums over every row of the batch (up to 1163264 at B = 64) with
# cancelling signs, so a share of max|twin| does not bound it
TWIN_TOL = {"out_bf16": 1e-2, "out_f32": 1e-4, "dX": 1e-4, "dW": 1e-4}
EVAL_KEYS = ("loss", "lang_scores", "attribute_scores", "relation_scores", "scene_scores",
             "seg_scores", "ref_iou")
OVERFLOW_KEYS = ("scene_overflow", "inst_overflow", "cand_overflow")
UNITS = {
    "value": "scenes/s", "step_ms": "ms", "device_scenes_s": "scenes/s",
    "train_scenes_s": "scenes/s", "eval_mfu": "fraction of 989e12 FLOP/s",
    "train_mfu": "fraction of 989e12 FLOP/s", "model_gflop_valid": "GFLOP a forward",
    "model_gflop_padded": "GFLOP a forward", "fed_train_scenes_s": "scenes/s",
    "fed_eval_scenes_s": "scenes/s", "e2e_scenes_s_1core_host": "scenes/s",
    "host_phase_ms": "ms", "profile": "ms a replay", "peak_memory_mib": "MiB",
    "occupancy_curve": "scenes/s",
}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def dense_flops(spec, batch_size: int) -> float:
    """``bench.py``'s coarse dense terms of one forward: the BEV head, the
    GRU and the word projection."""
    total = 2 * batch_size * spec.scene_caps[-1] * 128 * 128
    total += 2 * batch_size * 13 * 23 * 9 * 128 * 128
    total += 2 * batch_size * 11 * 21 * 9 * 128 * 128
    total += 2 * batch_size * spec.max_tokens * 2 * 2 * (256 * 384 + 128 * 384)
    total += 2 * batch_size * spec.max_tokens * (300 * 256 + 256 * 256)
    return total


def model_flops_padded(spec, batch_size: int) -> float:
    """``bench.py:model_flops_per_batch``: one forward's FLOPs with every
    conv at its padded capacity x its full kernel."""
    total = 0.0
    for caps in (spec.scene_caps, spec.inst_caps):
        cin = spec.feat_dim
        for s, cap in enumerate(caps):
            v = batch_size * cap
            if s == 0:
                total += 2 * v * 27 * cin * WIDTHS[0]
            else:
                total += 2 * v * 8 * WIDTHS[s - 1] * WIDTHS[s]
                total += 2 * 2 * v * 27 * WIDTHS[s] * WIDTHS[s]
    return total + dense_flops(spec, batch_size)


def conv_entries(batch: Dict[str, np.ndarray], spec):
    """(map key, valid entries, Cin, Cout, convs) of each sparse conv of a
    forward: per encoder the stem, and per stage the down conv and the two
    residual convs, which share their map."""
    out = []
    for prefix in ("scene", "inst"):
        out.append((f"{prefix}_nbr3_0", spec.feat_dim, WIDTHS[0], 1))
        for s in range(1, len(WIDTHS)):
            out.append((f"{prefix}_down_{s}", WIDTHS[s - 1], WIDTHS[s], 1))
            out.append((f"{prefix}_nbr3_{s}", WIDTHS[s], WIDTHS[s], 2))
    return [(key, int(np.count_nonzero(batch[key] >= 0)), cin, cout, n)
            for key, cin, cout, n in out]


def model_flops_valid(batch: Dict[str, np.ndarray], spec) -> float:
    """One forward's FLOPs on ``batch``: 2 x Cin x Cout for each valid entry
    of each conv's map, plus ``dense_flops``."""
    sparse = sum(2 * e * cin * cout * n for _, e, cin, cout, n in conv_entries(batch, spec))
    return sparse + dense_flops(spec, len(batch["lang_len"]))


def overflow_max(batch: Dict[str, np.ndarray]) -> float:
    return max(float(np.max(batch[k])) for k in OVERFLOW_KEYS)


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


class Steps:
    """A mode's step as the solver runs it: ``StepGraphs`` on a card
    (``step_graph.choose``), eagerly on the CPU."""

    def __init__(self, mode: str, model, optimizer, mean_size, spec):
        from instancerefer_tpu_torch.train.step_graph import choose

        self.mode, self.model, self.optimizer = mode, model, optimizer
        self.mean_size, self.spec = mean_size, spec
        self.graphs, self.path = choose(model, optimizer, mean_size)

    def load(self, batch: Dict[str, np.ndarray]) -> dict:
        from instancerefer_tpu_torch.data.host import finish, stage_to

        staged = stage_to(batch, self.spec, self.mean_size.device)
        if self.graphs is not None:
            return self.graphs.load(staged, self.spec, self.mode)
        return finish(staged, self.spec)

    def __call__(self, dd: dict):
        """(metrics, outputs) of one step on ``dd``."""
        if self.graphs is not None:
            step = self.graphs.train_step if self.mode == "train" else self.graphs.eval_step
            return step(dd)
        return eager_step(self.mode, self.model, self.optimizer, dd, self.mean_size)


def eager_step(mode: str, model, optimizer, dd: dict, mean_size):
    from instancerefer_tpu_torch.train.solver import train_step
    from instancerefer_tpu_torch.train.step_graph import eval_body

    if mode == "train":
        return train_step(model, optimizer, dd, mean_size)
    model.eval()
    return eval_body(model, dd, mean_size)


def split_step(mode: str, model, optimizer, dd: dict, mean_size) -> None:
    """One eager step for the module split: train keeps the gradient
    tensors the graph captured (``set_to_none=False``)."""
    from instancerefer_tpu_torch.train.step_graph import eval_body, train_body

    if mode == "train":
        model.train()
        train_body(model, optimizer, dd, mean_size, set_to_none=False)
    else:
        model.eval()
        eval_body(model, dd, mean_size)


def all_finite(*dicts) -> bool:
    return all(bool(torch.isfinite(v).all()) for d in dicts for v in d.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())


def step_state(mode: str, result, model) -> dict:
    """What the gate compares of a step, on the host: eval, its outputs;
    train, the loss, every parameter's gradient (zeros for none), the
    running statistics and the parameters after the step."""
    if mode == "eval":
        return {k: v.detach().cpu() for k, v in result[1].items() if isinstance(v, torch.Tensor)}
    params = dict(model.named_parameters())
    return {
        "loss": float(result[0]["loss"]),
        "grads": {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().float()
                  for n, p in params.items()},
        "stats": {n: b.detach().cpu().float() for n, b in model.named_buffers()
                  if "running" in n},
        "params": {n: p.detach().cpu().float() for n, p in params.items()},
    }


def compare(mode: str, got: dict, want: dict, lr: float) -> Dict[str, object]:
    """The first replay's ``step_state`` against the eager step's: the
    largest difference of each compared quantity, the limits, and whether
    all are within them."""
    if mode == "eval":
        res, ok = {}, True
        for key in EVAL_KEYS:
            x, y = got[key].float(), want[key].float()
            err = (x - y).abs()
            res[f"{key}_max_abs_diff"] = float(err.max()) if err.numel() else 0.0
            ok &= bool((err <= SLICE_ATOL + SLICE_RTOL * y.abs()).all())
        same_acc = bool(torch.equal(got["ref_acc"], want["ref_acc"]))
        res.update(ref_acc_equal=same_acc, limit=f"atol {SLICE_ATOL:g} + rtol {SLICE_RTOL:g}",
                   ok=ok and same_acc)
        return res
    a, b = got["loss"], want["loss"]
    loss_rel = abs(a - b) / abs(b)
    layer_norm: Dict[str, float] = {}
    for n, g in want["grads"].items():
        layer = n.rsplit(".", 1)[0]
        layer_norm[layer] = max(layer_norm.get(layer, 0.0), float(g.norm()))
    worst, num, den = (0.0, ""), 0.0, 0.0
    for n, g in want["grads"].items():
        d = float((got["grads"][n] - g).norm())
        worst = max(worst, (d / max(layer_norm[n.rsplit(".", 1)[0]], 1e-30), n))
        num, den = num + d * d, den + float(g.norm()) ** 2
    overall = (num / den) ** 0.5 if den else math.inf
    stats_ok = all(bool(((got["stats"][n] - s).abs() <= STATS_RTOL * s.abs() + 1e-5).all())
                   for n, s in want["stats"].items())
    param_ok, total, count = True, 0.0, 0
    for n, p in want["params"].items():
        diff = (got["params"][n] - p).abs()
        param_ok &= bool((diff <= 2.5 * lr + 1e-3 * p.abs()).all())
        total += float(diff.sum())
        count += diff.numel()
    drift = total / count / lr
    return {
        "loss_rel_diff": loss_rel, "grad_l2_overall": overall,
        "grad_l2_layer_max": worst[0], "grad_l2_layer_max_at": worst[1],
        "stats_ok": stats_ok, "params_within_2.5lr": param_ok, "param_mean_diff_lr": drift,
        "limit": f"loss rtol {LOSS_RTOL:g}; gradients L2 {GRAD_ALL:g} overall, {GRAD_LAYER:g} "
                 f"of a layer's norm; statistics rtol {STATS_RTOL:g} + 1e-5; parameters 2.5 lr "
                 f"+ 1e-3 |p| each, {ADAM_MEAN:g} lr on average",
        "ok": bool(loss_rel <= LOSS_RTOL and overall <= GRAD_ALL and worst[0] <= GRAD_LAYER
                   and den > 0 and stats_ok and param_ok and drift <= ADAM_MEAN),
    }


@contextlib.contextmanager
def held_against_twins(report: Dict[str, dict]):
    """Within the block, every call of K1's, K2's and K3's wrappers from
    the model (the convs of ``ops/sparse_conv``, the folded eval convs of
    ``models/basic_blocks``; the down convs' dX over the lists, K1's route
    there, against K1's twin over ``up8`` with W^T) is repeated by the
    kernel's plain twin (``ops/sparse``) on the same inputs.  ``report`` takes, per kernel, its
    calls and per output the largest |kernel - twin| in ``TWIN_TOL``'s
    units (bf16: over max|twin|; f32 sums: over each element's sum of term
    magnitudes, and where the kernel stored them in bf16 (K2's and the
    downs' dX) before that one rounding, ``precision.rounding_gap``); a
    stem's input padded to 16-byte rows reaches the twin unpadded."""
    from instancerefer_tpu_torch.models import basic_blocks
    from instancerefer_tpu_torch.ops import sparse, sparse_conv
    from instancerefer_tpu_torch.ops.precision import rounding_gap

    callers = (sparse_conv, basic_blocks)
    names = ("gather_conv", "down_dx", "subm_conv_bwd", "conv_dw")
    real = {n: getattr(sparse_conv, n) for n in names}
    patched = [(m, n) for m in callers for n in names if hasattr(m, n)]

    def note(kernel: str, kind: str, got: torch.Tensor, want: torch.Tensor,
             magnitude: Optional[torch.Tensor] = None) -> None:
        entry = report.setdefault(kernel, {"calls": 0})
        err = rounding_gap(got, want) if want.dtype == torch.float32 else \
            (got.float() - want.float()).abs()
        if magnitude is None:
            scale = want.float().abs().max() if want.numel() else 0.0
            rel = float(err.max() / scale) if scale else (math.inf if bool(err.any()) else 0.0)
        else:
            rel = float((err / magnitude.clamp_min(1e-30)).max()) if err.numel() else 0.0
        key = f"{kind}_max_rel_err"
        entry[key] = max(entry.get(key, 0.0), rel)

    def gather_conv(feats, nbr, weight, *args, **kw):
        out = real["gather_conv"](feats, nbr, weight, *args, **kw)
        x = feats[:, :weight.shape[1]]
        want = sparse.gather_conv(x, nbr, weight, *args, **kw)
        if out.dtype == torch.bfloat16:
            note("K1", "out_bf16", out, want)
        else:
            note("K1", "out_f32", out, want,
                 sparse.gather_conv(x.abs(), nbr, weight.abs(), out_dtype=torch.float32))
        report["K1"]["calls"] += 1
        return out

    def down_dx(g, nbr, up8, weight, lists, out_dtype=None):
        # K1's route at the down convs' dX: the twin is K1's over up8 with W^T
        out = real["down_dx"](g, nbr, up8, weight, lists, out_dtype)
        w_t = weight.transpose(1, 2).contiguous()
        want = sparse.gather_conv(g, up8, w_t, out_dtype=torch.float32)
        note("K1", "out_f32", out, want,
             sparse.gather_conv(g.abs(), up8, w_t.abs(), out_dtype=torch.float32))
        report["K1"]["calls"] += 1
        return out

    def subm_conv_bwd(feats, nbr, g, weight):
        dx, dw = real["subm_conv_bwd"](feats, nbr, g, weight)
        want_dx, want_dw = sparse.subm_conv_bwd(feats, nbr, g, weight)
        mag_dx, mag_dw = sparse.subm_conv_bwd(feats.abs(), nbr, g.abs(), weight.abs())
        note("K2", "dX", dx, want_dx, mag_dx)
        note("K2", "dW", dw, want_dw, mag_dw)
        report["K2"]["calls"] += 1
        return dx, dw

    def conv_dw(feats, nbr, g, cin=None, lists=None):
        dw = real["conv_dw"](feats, nbr, g, cin=cin, lists=lists)
        x = feats[:, :dw.shape[1]]
        note("K3", "dW", dw, sparse.conv_dw(x, nbr, g), sparse.conv_dw(x.abs(), nbr, g.abs()))
        report["K3"]["calls"] += 1
        return dw

    if any(getattr(m, n) is not real[n] for m, n in patched):
        raise AssertionError("the model's modules call other wrappers")
    wrapped = {"gather_conv": gather_conv, "down_dx": down_dx, "subm_conv_bwd": subm_conv_bwd,
               "conv_dw": conv_dw}
    try:
        for m, n in patched:
            setattr(m, n, wrapped[n])
        yield report
    finally:
        for m, n in patched:
            setattr(m, n, real[n])


def twins_ok(report: Dict[str, dict], mode: str) -> bool:
    """Every kernel of the step called as often as a step launches it, and
    every output within ``TWIN_TOL``."""
    want = dict(zip(COUNTER_NAMES, LAUNCHES[mode]))
    calls = {"K1": want["K1"], "K2": want["K2"], "K3": want["K3"]}
    return all(report.get(k, {"calls": 0})["calls"] == n for k, n in calls.items()) and all(
        v <= TWIN_TOL[key[:-len("_max_rel_err")]] for entry in report.values()
        for key, v in entry.items() if key.endswith("_max_rel_err"))


def counter_deltas(before, after) -> Dict[str, int]:
    return {name: a - b for name, a, b in zip(COUNTER_NAMES, after, before)}


def git_sha() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                              text=True, timeout=10, cwd=REPO).stdout.strip()
    except Exception:
        return ""


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_replays(step, dd, n: int):
    """``n`` calls of ``step(dd)``, each timed on the host clock up to
    ``torch.cuda.synchronize()`` on a card; (ms each, the last outputs,
    every call's loss)."""
    times, losses, result = [], [], None
    for _ in range(n):
        if dd["lang_feat"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = step(dd)
        if dd["lang_feat"].is_cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(result[0]["loss"])
    return times, result, losses


class _Watched:
    """A loader whose batches' largest capacity overflow is kept."""

    def __init__(self, loader):
        self.loader, self.overflow, self.batches = loader, 0.0, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.overflow = max(self.overflow, overflow_max(batch))
            self.batches += 1
            yield batch


def fed_rate(mode: str, model, cfg, spec, batch_size: int, seed: int, iters: int, dev,
             root_kw: dict) -> Dict[str, object]:
    """The solver's feed of ``1 + iters`` batches: a ScanRefer-layout root
    in a temporary directory, the split's ``PaddedLoader`` at ``spec``'s
    caps as the CLIs set it, ``Solver._feed``.  Per iteration
    (``Solver.log``): the wait for a staged batch, the ``finish`` into the
    graph's inputs, the producer thread's staging, the step; scenes/s over
    the iterations after the first (the capture); the fed batches' largest
    capacity overflow.  Then the same loader alone, no copy and no step
    (``loader_only_scenes_s``, over the same iterations), and the host's
    ``os.cpu_count()``."""
    from instancerefer_tpu_torch.data.dataset import (
        PaddedLoader,
        ScannetReferenceDataset,
        get_scanrefer,
    )
    from instancerefer_tpu_torch.data.scannet_config import ScannetDatasetConfig
    from instancerefer_tpu_torch.data.synthetic_scans import write_fake_scanrefer
    from instancerefer_tpu_torch.train.solver import Solver
    from instancerefer_tpu_torch.train.step_graph import launch_counts

    split = "train" if mode == "train" else "val"
    batches = 1 + iters
    n_scenes = math.ceil(batches * batch_size / DESCRIPTIONS_PER_SCENE)
    root = tempfile.mkdtemp(prefix="bench_fed_")
    try:
        t0 = time.perf_counter()
        write_fake_scanrefer(root, np.random.default_rng(seed), {split: batches}, batch_size,
                             scenes={split: range(n_scenes)}, **root_kw)
        written = time.perf_counter() - t0
        cfg = copy.copy(cfg)
        cfg.data_root = root
        dc = ScannetDatasetConfig(meta_dir=cfg.path_scannet_meta)

        def make_loader():
            """The split's loader as the CLIs make it, on a dataset of its
            own (the eval split's scene-block cache starts empty)."""
            dataset = ScannetReferenceDataset(
                get_scanrefer(root, split), split, data_root=root, num_points=cfg.num_points,
                use_color=cfg.use_color, use_height=cfg.use_height, use_normal=cfg.use_normal,
                use_multiview=cfg.use_multiview,
                use_augment=cfg.use_augment if split == "train" else False, seed=cfg.seed, dc=dc)
            return PaddedLoader(
                dataset, spec, batch_size, shuffle=split == "train", seed=cfg.manual_seed,
                num_workers=cfg.num_workers, drop_last=False, voxel_size_ap=cfg.voxel_size_ap,
                voxel_size_glp=cfg.voxel_size_glp)

        with contextlib.redirect_stdout(sys.stderr):
            watched = _Watched(make_loader())
            solver = Solver(model, MEAN_SIZE, spec, dev, lr=cfg.lr, wd=cfg.wd,
                            output_dir=os.path.join(root, "outputs"))
            solver.epoch, solver.verbose = 1, 1 << 30  # one epoch, no iter report
            before = launch_counts()
            solver._feed(watched, split, 0)
            launches = counter_deltas(before, launch_counts())
            # the same batches from the loader alone: the feed's ceiling
            # with these build threads
            loader_s = []
            start = time.perf_counter()
            for _ in make_loader():
                loader_s.append(time.perf_counter() - start)
                start = time.perf_counter()
        log_ = solver.log[split]
        iter_s = log_["iter_time"][1:]
        step_s = [it - f for it, f in zip(iter_s, log_["fetch"][1:])]
        return {
            "split": split, "iterations": len(iter_s), "batch": batch_size,
            "scenes": n_scenes, "workers": cfg.num_workers, "steps": solver._step_path,
            "scenes_s": batch_size * len(iter_s) / sum(iter_s) if iter_s else None,
            "fetch_load_ms": float(np.median(log_["fetch_load"][1:])) * 1e3,
            "fetch_copy_ms": float(np.median(log_["fetch_copy"][1:])) * 1e3,
            "fetch_stage_ms": float(np.median(log_["fetch_stage"][1:])) * 1e3,
            "step_ms": float(np.median(step_s)) * 1e3,
            "loader_only_scenes_s": (batch_size * len(loader_s[1:]) / sum(loader_s[1:])
                                     if loader_s[1:] else None),
            "cpu_count": os.cpu_count(),
            "root_written_s": written,
            "overflow_max": watched.overflow, "batches_seen": watched.batches,
            "launches": launches, "all_finite": bool(np.isfinite(log_["loss"]).all()),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def host_split(spec, batch_size: int, seed: int, scene_kw: dict, workers: int):
    """``pad_sample``'s phases on one sample and ``collate``'s ms (medians
    of ``HOST_REPS``), and the host's batch build alone (``pad_sample`` on
    ``workers`` threads, then ``collate``): scenes/s over its median."""
    from concurrent.futures import ThreadPoolExecutor

    from instancerefer_tpu_torch.data.pipeline import collate, pad_sample
    from instancerefer_tpu_torch.data.synthetic import make_core_sample
    from instancerefer_tpu_torch.scripts.bench_host_pipeline import median_ms, phase_split

    rng = np.random.default_rng(seed + 1)
    cores = [make_core_sample(rng, scan_idx=i, mean_size_arr=MEAN_SIZE, **scene_kw)
             for i in range(batch_size)]
    phases = phase_split(cores[0], spec, reps=HOST_REPS)
    padded = [pad_sample(c, spec) for c in cores]
    phases["collate_ms"] = median_ms(lambda: collate(padded, spec), reps=HOST_REPS)
    with ThreadPoolExecutor(workers) as pool:
        def build():
            collate(list(pool.map(lambda c: pad_sample(c, spec), cores)), spec, pool=pool)

        build_ms = median_ms(build, reps=HOST_REPS)
    return phases, batch_size / build_ms * 1e3


def run(args) -> dict:
    from instancerefer_tpu_torch.config import band_profile_kwargs, load_config
    from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
    from instancerefer_tpu_torch.models.instancerefer import build_model
    from instancerefer_tpu_torch.ops import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.ops.voxelize import native_available
    from instancerefer_tpu_torch.scripts.step_ab import host_probe
    from instancerefer_tpu_torch.train.solver import make_optimizer
    from instancerefer_tpu_torch.train.step_graph import launch_counts
    from instancerefer_tpu_torch.utils.profiling import device_profile, module_split

    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; pass --device cpu for the CPU rehearsal")
    dev = torch.device("cuda", 0) if card else torch.device("cpu")

    def timed(x):  # a time-derived value: only a card's
        return x if card else None

    mode, b = args.mode, args.batch
    result: Dict[str, object] = {"config": CONFIG_NAME, "mode": mode, "batch": b,
                                 "seed": args.seed}
    if card:
        smi = nvidia_smi()
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": torch.cuda.device_count(), "name_power_limit": smi}
        log(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        gather_conv.build()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0}
    probe_before = host_probe()

    # the yaml's model with the fitted caps and one language grid of
    # max_des_len tokens (the rehearsal: TEST_SPEC's)
    cfg = load_config(["--config", CONFIG, "--device", args.device])
    caps = band_profile_kwargs(PROFILE) if card else {
        k: getattr(TEST_SPEC, k) for k in ("scene_caps", "inst_caps", "max_candidates",
                                           "max_instances")}
    for k, v in caps.items():
        setattr(cfg, k, v)
    cfg.lang_bucket = 0
    if not card:
        cfg.max_des_len = TEST_SPEC.max_tokens
    spec = cfg.batch_spec()
    if not card and spec != TEST_SPEC:
        raise AssertionError(f"the rehearsal's spec {spec} is not TEST_SPEC")
    scene_kw = SCENE_KW if card else CPU_SCENE_KW
    set_compute_dtype(cfg.compute_dtype)
    t0 = time.perf_counter()
    batch = make_batch(b, spec, seed=args.seed, mean_size_arr=MEAN_SIZE, **scene_kw)
    log(f"a batch of {b} scenes built" + (f" in {time.perf_counter() - t0:.1f} s" if card else ""))
    overflow = overflow_max(batch)
    flops_valid = model_flops_valid(batch, spec)
    flops_padded = model_flops_padded(spec, b)

    model = build_model(cfg, generator=torch.Generator().manual_seed(args.seed)).to(dev)
    optimizer = make_optimizer(model.parameters(), cfg.lr, cfg.wd) if mode == "train" else None
    mean_size = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    steps = Steps(mode, model, optimizer, mean_size, spec)
    log(f"steps: {steps.path}")

    # 1. warm-up and capture; the first replay against an eager step of a
    # copy of the model and its optimizer, from one state, whose kernels
    # are held against their plain twins
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    dd = steps.load(batch)
    warm = steps(dd)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 if card else None
    twin, twin_opt = copy.deepcopy((model, optimizer))
    twins: Dict[str, dict] = {}
    torch.manual_seed(args.seed)  # the same dropout masks in both steps
    with held_against_twins(twins):
        want = step_state(mode, eager_step(mode, twin, twin_opt, dd, mean_size), twin)
    before = launch_counts()
    torch.manual_seed(args.seed)
    first = steps(dd)
    agree = compare(mode, step_state(mode, first, model), want, cfg.lr)
    finite = all_finite(*warm, *first)
    del warm, want, twin, twin_opt
    log(f"{mode} step: the first replay against the copy's eager step: "
        + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in agree.items() if k != "limit")
        + "; the eager step's kernels against their twins: "
        + "; ".join(f"{k} " + ", ".join(f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}"
                                        for n, v in e.items()) for k, e in twins.items()))

    iters = ITERS[mode] if args.iters is None else args.iters
    times, last, losses = time_replays(steps, dd, iters)
    n_steps = 1 + iters
    launches = counter_deltas(before, launch_counts())
    finite &= all_finite(*last) and bool(torch.isfinite(torch.stack(losses)).all())
    step_ms = float(np.median(times))
    scenes_s = b / step_ms * 1e3
    step_flops = flops_valid * (3 if mode == "train" else 1)
    mfu = step_flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
    log(f"{mode} step B={b}: median {step_ms:.3f} ms, p90 {percentile(times, 90):.3f} ms "
        f"over {len(times)} replays: {scenes_s:.2f} scenes/s; {step_flops / 1e9:.1f} GFLOP a "
        f"step -> {mode}_mfu {mfu:.4f}" if card else f"{mode} step: {len(times)} eager steps")

    # 2. one profiled window, apart from the timed replays
    prof = None
    if card:
        prof = device_profile(lambda: steps(dd), PROFILE_CALLS)
        # the profiler's wall holds its own cost: the idle share of the
        # timed replays' median is the other reading
        prof["idle_share_of_median_step"] = 1.0 - prof["device_busy_ms"] / step_ms
        log(f"profile ({PROFILE_CALLS} replays): device busy {prof['device_busy_ms']:.3f} ms a "
            f"replay of {prof['wall_ms']:.3f} ms under the profiler (idle "
            f"{prof['idle_share']:.1%}; of the median step {prof['idle_share_of_median_step']:.1%}"
            f"; within a replay {prof['idle_within_calls_ms']:.3f} ms); sparse "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["sparse_ms"].items()) + "; dense "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["dense_ms"].items())
            + f"; peak memory {peak:.1f} MiB; launches agree with the counters: "
            + ("yes" if prof["agrees"] else prof["why"]))
        # the device ms by module, from eager steps (a replay keeps no spans)
        prof["modules"] = module_split(lambda: split_step(mode, model, optimizer, dd, mean_size),
                                       MODULE_STEPS, log)
        log(f"{MODULE_STEPS} eager {mode} steps by module (device ms a step, forward / "
            "backward): " + "; ".join(f"{k} {v['forward']:.3f} / {v['backward']:.3f}"
                                      for k, v in prof["modules"]["modules"].items())
            + f"; unattributed {prof['modules']['unattributed_ms']:.3f} of "
            f"{prof['modules']['device_ms']:.3f}")

    # 3. the occupancy curve (eval)
    curve = []
    if mode == "eval":
        for pts, ninst in OCCUPANCY if card else CPU_OCCUPANCY:
            kw = dict(scene_kw, num_points=pts, num_instances=ninst)
            occ = batch if pts == scene_kw["num_points"] else make_batch(
                b, spec, seed=args.seed + 2, mean_size_arr=MEAN_SIZE, **kw)
            occ_dd = steps.load(occ)
            before_occ = launch_counts()
            t, out, occ_losses = time_replays(steps, occ_dd, max(iters // 2, 3) + 1)
            per = counter_deltas(before_occ, launch_counts())
            n_steps += len(t)
            launches = {k: launches[k] + per[k] for k in launches}
            finite &= all_finite(*out) and bool(torch.isfinite(torch.stack(occ_losses)).all())
            live = float((occ["scene_owner_0"] >= 0).mean())
            curve.append({"points": pts, "live_voxel_frac": round(live, 4),
                          "eval_scenes_s": timed(b / float(np.median(t[1:])) * 1e3),
                          "replays": len(t) - 1, "overflow_max": overflow_max(occ)})
            log(f"occupancy {pts} points (live {live:.3f}, overflow "
                f"{curve[-1]['overflow_max']:.4f}): "
                + (f"{curve[-1]['eval_scenes_s']:.2f} scenes/s" if card else "eager"))
    per_step = {k: v / n_steps for k, v in launches.items()}
    del dd, steps
    if card:
        torch.cuda.empty_cache()

    # 4. the fed rate through the solver
    fed = fed_rate(mode, model, cfg, spec, b, args.seed, args.fed_iters, dev,
                   {} if card else CPU_ROOT_KW)
    finite &= fed["all_finite"]
    fed_per_step = {k: v / (1 + fed["iterations"]) for k, v in fed["launches"].items()}
    log(f"fed {fed['split']}: " + (
        f"{fed['scenes_s']:.2f} scenes/s over {fed['iterations']} iterations; per iteration "
        f"fetch_load {fed['fetch_load_ms']:.1f} ms, fetch_copy {fed['fetch_copy_ms']:.1f} ms, "
        f"fetch_stage {fed['fetch_stage_ms']:.1f} ms, step {fed['step_ms']:.1f} ms; the loader "
        f"alone {fed['loader_only_scenes_s']:.2f} scenes/s; {fed['workers']} workers, "
        f"nproc {fed['cpu_count']}; "
        if card else f"{fed['iterations']} iterations; ")
        + f"overflow {fed['overflow_max']:.4f}")
    for k in ("scenes_s", "fetch_load_ms", "fetch_copy_ms", "fetch_stage_ms", "step_ms",
              "loader_only_scenes_s", "root_written_s"):
        fed[k] = timed(fed[k])

    # 5. the host alone
    phases, build_scenes_s = host_split(spec, b, args.seed, scene_kw, cfg.num_workers)
    log("host phases (ms, medians of 5): " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
        + f"; batch build {build_scenes_s:.2f} scenes/s with {cfg.num_workers} workers"
        if card else f"host phases: {', '.join(phases)}")

    want_launches = dict(zip(COUNTER_NAMES, LAUNCHES[mode] if card else (0,) * len(COUNTER_NAMES)))
    # a train epoch tilts and moves each scene, and the caps were fitted to
    # unaugmented ones (ROADMAP §3): the fed train batches' overflow is read
    fed_overflow_gated = mode == "eval"
    checks = {
        "replay_vs_eager": agree, "kernels_vs_twins": twins,
        "kernels_vs_twins_ok": twins_ok(twins, mode), "finite": finite,
        "overflow_max": overflow, "fed_overflow_max": fed["overflow_max"],
        "fed_overflow_gated": fed_overflow_gated, "launches_per_step": per_step,
        "fed_launches_per_step": fed_per_step, "launches_expected": want_launches,
    }
    correct = bool(agree["ok"] and checks["kernels_vs_twins_ok"] and finite and overflow == 0
                   and (fed["overflow_max"] == 0 or not fed_overflow_gated)
                   and per_step == want_launches and fed_per_step == want_launches)
    if not card:
        phases = {k: None for k in phases}
    result.update({
        "metric": f"{mode}_scenes_per_sec",
        "value": timed(scenes_s),
        "unit": "scenes/s",
        "vs_baseline": timed(scenes_s / A100_REFERENCE_SCENES_PER_SEC),
        "baseline_note": "vs_baseline divides by a 15 scenes/s A100 ESTIMATE of the "
                         "reference's forward (the reference publishes no throughput)",
        "step_ms": {"median": timed(step_ms), "p90": timed(percentile(times, 90)),
                    "n": len(times)},
        "device_scenes_s": timed(scenes_s) if mode == "eval" else None,
        "train_scenes_s": timed(scenes_s) if mode == "train" else None,
        f"fed_{mode}_scenes_s": fed["scenes_s"],
        "e2e_scenes_s_1core_host": timed(build_scenes_s),
        "eval_mfu": timed(mfu) if mode == "eval" else None,
        "train_mfu": timed(mfu) if mode == "train" else None,
        "model_gflop_valid": flops_valid / 1e9,
        "model_gflop_padded": flops_padded / 1e9,
        "step_gflop_valid": step_flops / 1e9,
        "occupancy_curve": curve,
        "host_phase_ms": phases,
        "e2e_workers": cfg.num_workers,
        "e2e_median_of": HOST_REPS,
        "fed": fed,
        "profile": prof,
        "peak_memory_mib": peak,
        "correct": correct,
        "checks": checks,
        "native_voxelizer": native_available(),
        "nproc": os.cpu_count(),
        "git_sha": git_sha(),
        "host_probe": {"before": timed(probe_before), "after": timed(host_probe())},
        "units": UNITS,
    })
    set_compute_dtype(None)
    return result


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("train", "eval"), required=True)
    ap.add_argument("--batch", type=int, default=32, help="scenes a batch (the yaml's: 64)")
    ap.add_argument("--seed", type=int, default=0, help="weights, scenes and the fed root")
    ap.add_argument("--iters", type=int, default=None,
                    help=f"timed replays (default: {ITERS['train']} train, {ITERS['eval']} eval)")
    ap.add_argument("--fed-iters", type=int, default=30,
                    help="iterations of the fed rate after the capture")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) needs a card; cpu is the rehearsal")
    args = ap.parse_args(argv)
    result = run(args)
    print(json.dumps(result), flush=True)
    if not result["correct"]:
        raise SystemExit(f"bench: the result is not correct: {result['checks']}")
    return result


if __name__ == "__main__":
    main()
