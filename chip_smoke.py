"""Drive the PyTorch/CUDA port's eval forward and train step on one GPU.

    python3 chip_smoke.py

The main path's steps run as the solver runs them on one card: as CUDA
graphs (``train/step_graph.StepGraphs``), a key's first batch eagerly and
the rest as replays (phases 4, 7, 8, 9, 11); phase 12 puts the graphs
beside the eager steps.  Phases, in order; any failure exits nonzero
without the final ``ok`` line:

1. Device: the card's name and power limit (``nvidia-smi``) and the port's
   own native voxelizer library (built with ``g++`` from
   ``instancerefer_tpu_torch/native/``), which must be in use; the build of
   every CUDA source under ``instancerefer_tpu_torch/csrc/`` (one ``nvcc``
   each, all at once), whose ``-Xptxas -v`` reports must show no spills.
2. K1 vs plain twin: the CUDA gather-GEMM against ``ops/sparse.gather_conv``
   at six main-path shapes of a 32-scene batch (scene and instance stems
   7 -> 32 over ``nbr3``, stage-1 down 32 -> 64 over ``down``, stage-2,
   stage-3 and stage-4 residuals 128 -> 128 over ``nbr3``: on the
   tensor-core route each tile plan, 64-row tiles alone at the down and
   the stage-2 residual, split over a cluster of 2 blocks at stage 3 and of
   4 at stage 4, each printed with its ``[kernel]`` line), in f32 (the FMA
   kernel) and
   bf16 (the stem kernel at the stems, the tensor-core kernel elsewhere),
   with and without the fused BN/ReLU epilogue.  Times are CUDA-event
   medians of 10.  Each
   line also gives the bound (the larger of the bytes over 3.35 TB/s and the
   flops of the map's valid entries over the H100's peak for the type: 989
   TFLOP/s bf16, 67 TFLOP/s f32) and the im2col yardstick: no single
   PyTorch call computes a gather-GEMM, so one index gather into
   [V, K*Cin] and one ``torch.mm`` (K2: two, K3: one), which only this
   script runs.
3. Slice parity, card vs CPU: eval forward + ``get_loss`` + ``get_eval`` on
   a 2-scene batch at the full-size spec, f32 with TF32 off, BN running
   statistics moved off their defaults.
4. Eval at full size: 32-scene batches (the bench's synthetic scenes) in the
   bf16 policy, three batches from distinct seeds, the first repeated (the
   eval step's graph: a warm-up that captures, then replays);
   outputs finite, ``ref_iou`` in [0, 1], 26 kernel launches per forward;
   eval scenes/s and peak device memory; then one replay under
   ``torch.profiler``: the sparse-conv kernels' device time by wrapper, the
   device's busy time and idle share, and the launches the profiler saw,
   which must equal what the counters added (a replay runs no Python: the
   counters add what the capture counted) (``[profile]``).
5. K2, K3 and the down convs' dX vs their plain versions on the maps of
   the 32-scene batch: K3 at every shape a train step launches it at (both
   stems, K = 27, 7 -> 32, and the four down convs of both encoders, K = 8,
   32 -> 64, 64 -> 128, 128 -> 128 twice; at the downs also the list pass
   alone, ``conv_bwd.dw_lists``, equal to ``dw_lists_plain`` in every
   entry, with its CUDA-event median and bound, ``[list]``), K2 at every
   residual of both encoders (stage 1 64 -> 64, stages 2-4 128 -> 128;
   each dX plan and its dW group and splits printed), f32 and bf16 inputs,
   two launches on the same inputs give bit-identical dW; then the dX of
   every down of both encoders over the lists of its map
   (``conv_bwd.down_dx``, bf16 in, f32 out) against ``down_dx_plain`` on
   the same lists in the kernel's split and tile order, two launches
   bit-identical, the rows no entry names 0, its blocks a list
   (``[down-dx]``; the plain version is timed over whole lists, its
   vectorised form).  CUDA-event medians of 10, with
   bound and yardstick as in phase 2 (the dX's: an index gather over
   ``up8`` and one ``torch.mm``).
6. Train parity, card vs CPU: one ``train_step`` on a 2-scene batch at the
   full-size spec, f32, TF32 off, deterministic cuDNN, dropout 0, the same
   weights: loss, every parameter gradient, the running statistics, then
   the parameters after a second Adam step.
7. Train at full size: 32-scene batches in the bf16 policy, one warm-up
   step (which captures the train step's graph), 5 timed replays, then one
   step on each of 2 more batches; loss and
   every gradient finite, ``ref_iou`` in [0, 1], 34 / 16 / 10 launches of
   K1 / K2 / K3 per step; train scenes/s and peak device memory; then one
   step under ``torch.profiler``, as in phase 4.
8. The CLIs at full width: a fake ScanRefer root (40 000 points and 12
   instances a scene, the 18-class label map, 64 descriptions a scene as
   in ScanRefer: 16 train batches of 32 over 8 scenes, 8 val batches over
   4) and ``config/InstanceRefer.yaml`` as text with batch 32, 2 epochs,
   the lr milestone after epoch 1 and the fitted caps of
   ``config/band_profile.synthetic.yaml``.  ``main(argv)`` of train, eval
   (cold, then from its cache), train resumed for a third epoch, and one
   epoch with ``use_gt_lang: False``, each with the launch counters set to 0
   just before and read just after: 34 / 16 / 10 launches of K1 / K2 / K3
   per train step, 26 of K1 per eval forward, none from the cache.  The
   artifacts exist, every logged loss is finite, the logged lr (Adam's own
   float32 tensor) equals the float32 schedule exactly (``LR_F32``: 1e-3,
   then 1e-3 x 0.1 after the milestone), and a resumed run goes on from
   epoch 3 at that lr.  ``[cli]`` lines give
   the train CLI's scenes/s per iteration (fetch + step) in the steady
   state (every iteration but an epoch's first) and over its whole run
   (validation and checkpoints included), the eval CLI's scenes/s end to
   end, and the iter reports' means: fetch (split into the wait for a
   staged batch and ``finish``; beside them the prefetcher thread's
   staging), forward, backward, eval.

9. The multiview input path, with its own wall time (``[phase 9]``):
   - K1 (f32 and bf16, with and without the epilogue) and K3 at both stems
     of the 32-scene batch at Cin 10 and 135 against their twins (limits as
     phases 2 and 5), with route, CUDA-event median, bound and the im2col
     yardstick (in chunks of rows: 8.5 GB in f32 at the scene stem at
     Cin 135); bf16 must not take the FMA kernels, and two launches give
     bit-identical dW (``[stem-width]``).
   - ENet card vs CPU on 8 random 256x328 frames (random weights, BatchNorm
     statistics moved off their defaults, f32, TF32 off): features and
     logits; frames/s at batches of 8 and 32 and the peak memory
     (``[enet]``).
   - Projection and maxpool fusion of 64 frames' ENet features onto a room
     of 100 000 surface points, each frame's 32x41 depth rendered with a
     z-buffer: card vs CPU, at most 1e-4 of the correspondences may differ,
     more than half of the points covered (``[projection]``).
   - ``use_multiview`` (Cin 135) at B = 32 from the port's own dataset on a
     fake root like phase 8's (``_multiview_feats`` served from the fused
     features: the card's machine has no h5py): the train step as phase 7
     and the eval forward as phase 4, with their launch counts and stems on
     the stem kernels, the batch-build ms, then the B = 2 f32 train parity
     of phase 6 at Cin 135; one ``use_normal`` (Cin 10) train step.

10. Data parallelism on the one card, and the overfit check, with its own
    wall time (``[phase 10]``):
    - 10a: two ranks, one process each, on ``cuda:0`` over gloo (NCCL
      refuses two ranks on one card), meeting through a ``file://`` store;
      each loads its half of 32 of the bench's scenes with its
      ``PaddedLoader`` shard (``host_shard_indices``) and trains the
      ``Solver``'s DDP model.  One f32 step (TF32 off, dropout 0) against
      one process's step on the 32 scenes in the ranks' order: the loss,
      the gradients and the running statistics to phase 6's limits.  Then
      3 bf16 steps: 34 / 16 / 10 launches of K1 / K2 / K3 a step on each
      rank, the parameters bit-identical across the ranks after the last;
      ``[ddp]`` lines give each rank's step ms and, from one profiled step,
      the collectives by profiler event with their host and device time.
    - 10b: the train CLI's ``main(argv)`` at world size 1 over NCCL
      (``RANK=0 WORLD_SIZE=1``, ``env://`` on localhost) for one epoch on a
      fake root like phase 8's with 4 train and 2 val batches: phase 8's
      launches a step, no DDP wrapper, one run directory, finite losses;
      then one NCCL all-reduce over that group returns its input, and
      phase 7's train steps run in the group (their launches and time).
    - 10c: ``scripts/sanity_train`` (60 bf16 steps at B = 16 on the
      largest-instance rule) must pass; its early and late ``ref_acc``.

11. Raw ScanNet scans to a step, with its own wall time (``[phase 11]``):
    - 11a: two synthetic scans in ScanNet's raw layouts
      (``data/synthetic_scans``: a 150 000-vertex, 300 000-face binary PLY
      room of floor, walls and 12-20 furniture boxes, its segments,
      aggregation and a non-identity axis alignment, 12 PointGroup masks).
    - 11b: the port's exporter (``data/prepare.batch_export``) on the card
      and on the CPU; the files agree (normals within NORMAL_TOL, aligned
      xyz and boxes within COORD_ULP, the rest equal); per scan the ms of
      parsing, device work and saving, card beside CPU.
    - 11c: 32 descriptions over the kept objects, the caps fitted to the
      prepared root (``scripts/fit_caps``, on the eval split), one batch of
      32 from the port's dataset for train (augmented) and eval (the eval
      CLI's overflow gate must pass); a bf16 train step (34 / 16 / 10
      launches) and the eval forward (26), as phases 7 and 4.
    - 11d: the reference's unused loss variants and the named loss pieces
      at B = 32, C = 4 and 32, card vs CPU (values and input gradients).
    - 11e: ``scripts/visualize --boxes`` on a prepared scene: the OBJ files
      hold the prepared vertex and box counts.

12. The steps' CUDA graphs beside the eager steps, with its own wall time
    (``[phase 12]``):
    - 12a: f32, TF32 off, deterministic cuDNN, dropout 0, the same
      weights, two 2-scene batches of one language grid with other
      description lengths (A, B): the train graph captured on A replays B
      and then A against eager steps on the same batches from one state
      (loss, gradients and running statistics to phase 6's limits, the
      parameters after the 2 steps), beside a second eager model's steps
      (the floor of eager against eager on the card); the eval graph
      captured on A replays B against the eager eval step on B (phase 3's
      limits), beside that eager step run twice.
    - 12b: bf16 at B = 32 through the ``Solver``: batches of two language
      grids (126 and 64: two keys), a checkpoint load that drops every
      graph, the recaptures; 34 / 16 / 10 launches a step throughout.
    - 12c: at lr 0 two replays of one batch draw new dropout masks (their
      losses differ), while with dropout 0 the loss repeats.
    - 12d: train and eval scenes/s of both paths at B = 32 (the same
      weights and batch), in runs alternated eager, graph, graph, eager,
      with each path's peak device memory; a graph step and an eager step
      of each kind under the profiler (the device's idle share).
    - 12e: every launch of a train step and an eval step, recorded at the
      capture by shape, against the profiler over 10 replays: each shape's
      launches in each step, its plan (on tensor cores: K1's and K2's
      tiles, K3's list splits), its bound and the device's own ms a launch
      (``[shape]``).
    - 12f: the train and eval step bodies run eagerly under
      ``torch.cuda.set_sync_debug_mode("error")``.

13. The bench and one batch stepped on, with its own wall time
    (``[phase 13]``):
    - 13a: ``python -m instancerefer_tpu_torch.scripts.bench --mode eval``,
      then ``--mode train``, at B = 32 with 5 timed replays and 10 fed
      iterations, each in a process of its own: platform gpu, the bench's
      correctness gate true (the first replay against an eager step of a
      copy from one state, that step's kernels against their plain twins,
      finite outputs, no overflow), 26 and 34 / 16 / 10 launches a step in
      its timed replays and in its fed run; ``[bench]`` lines give its
      readings.
    - 13b: f32, TF32 off, deterministic cuDNN, dropout 0, 5 runs of their
      own weights and 2-scene batch: the batch stepped 3 times by an eager
      model, its eager twin and a graphed one from the same weights,
      free-running and from one state copied before each step: the loss
      and gradients of the graph against eager read beside eager against
      eager after each step, as distributions over the runs (Adam turns
      the atomics' last bits into ~lr in the weights, and later steps are
      ill-conditioned); the first step held to phase 6's limits; from one
      state, the later steps' loss and gradients to phase 6's limits or 4x
      the floor's largest, the running statistics to phase 6's limits and
      the parameters after every step (``[drift]``).

14. The feed's prefetcher (``data/prefetch.DevicePrefetcher``: batches
    staged on a thread into page-locked buffers, copied on a side stream,
    ``finish``ed on the card), with its own wall time (``[phase 14]``):
    - 14a: an epoch of 6 augmented batches of 8 from a fake root through
      ``Solver._feed`` on its step graphs, f32, deterministic algorithms:
      every batch finished into the graph's inputs equals
      ``batch_to_torch``'s in every bit (``torch.equal``) before its step;
      the fed split (``[prefetch]``).
    - 14b: the same epoch fed synchronously through ``batch_to_torch(out=)``
      from the same weights: the same losses, exactly.
    - 14c: 16 two-scene batches from a list with a sleep on the card before
      each eval replay: each batch's finished checksum on the card equals
      the host's, so no staging set was rewritten before it was read.

Then one line ``{"kernels": [...]}`` (launch counts of phase 7, whose
profiled replay showed the profiler's launches equal to the counters'; ms,
plain_ms, bound_ms and im2col_ms of K1 from phase 2, of K2, K3 and the
down convs' dX from phase 5, bf16 summed over the shapes (K2: its 8
residual shapes, one launch each; the dX, K1's route at the downs and
among K1's launches, on its own row; the list pass, which each down's
backward runs once for its dX and K3, on its own row); then K1 and K3 at
the stems at
Cin 135 and 10, with their stem-kernel launches in phase 9's train runs
and the times of phase 9's first part; library_ms is null, since no single
PyTorch call computes these functions), the ``nvidia-smi`` line and, last,
``{"ok": true, "device": ...}``.  Weights are random (``torch.Generator``
seeds); scenes are synthetic.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from instancerefer_tpu_torch.data.synthetic_scans import SCANREFER_SCENES as CLI_SCENES
from instancerefer_tpu_torch.data.synthetic_scans import (
    description,
    write_fake_scanrefer,
    write_glove,
)
from instancerefer_tpu_torch.utils.profiling import KERNEL_FAMILIES

# the capacities of config/band_profile.synthetic.yaml, as literals (no yaml
# here); the port ignores its band geometry
SPEC_KW = dict(
    scene_caps=(18176, 4352, 1280, 512, 256),
    inst_caps=(1792, 1792, 1280, 512, 256),
    max_candidates=8,
    max_instances=24,
)
SCENE_KW = dict(num_points=40000, num_instances=12, num_candidates=4)
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
BATCH = 32
CONVS_PER_FORWARD = 26  # 2 encoders x (stem + 4 x (down + 2 subm))
FEAT_DIM = 7  # the stems' Cin: xyz, rgb, height
WIDTHS = (32, 64, 128, 128, 128)  # the encoders' channels by stage
ENCODERS = (("scene", "scene"), ("instance", "inst"))  # (label, batch key prefix)
# kernel vs twin: |err| <= TOL * max|ref|.  f32 differs only in summation
# order; bf16 outputs round the same f32 sum, so they may differ by one
# bf16 ulp (2^-7 relative) where the two sums straddle a rounding boundary.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# slice parity, card vs CPU (f32, TF32 off): |gpu - cpu| <= ATOL + RTOL*|cpu|;
# sums run in other orders and the BEV scatter uses atomics
SLICE_ATOL, SLICE_RTOL = 1e-4, 1e-3
# K2/K3/the downs' dX vs twin: |err| <= tol * max|ref|.  The outputs are f32 for
# both input types (bf16 inputs are exact in f32), so only the order of the
# f32 sums differs; dW sums over every row of the batch (up to 581632).
DX_TOL, DW_TOL = 1e-5, 1e-4
# train parity, card vs CPU (f32): the loss to LOSS_RTOL and the running
# statistics to STATS_RTOL (forward quantities, well conditioned).  The
# gradients of a 2-scene train step are not: max-pool winners and ReLU
# signs switch under rounding, and a BatchNorm over 2 rows has an
# analytically zero gradient held as rounding noise.  On the CPU, a 1e-6
# relative perturbation of the weights moved them by up to 1.2% of a
# layer's gradient norm and 0.7% overall (L2).  So each parameter's
# gradient must agree to GRAD_LAYER x the largest gradient norm of its
# layer, and all of them together to GRAD_ALL, in L2.  After the second
# Adam step each parameter lies within 2.5 x the summed lr + 1e-3 |p|: Adam
# moves an element by about +-lr whatever its gradient's size, so elements
# whose gradient is within rounding of 0 land on a coin flip, and the
# second step's gradients are taken at weights that already differ.  The
# mean difference over all elements must stay below ADAM_MEAN x lr (0.074
# lr measured on an H100; a wrong lr or moment on one side moves it to
# about lr).
LOSS_RTOL, STATS_RTOL, GRAD_LAYER, GRAD_ALL, ADAM_MEAN = 1e-4, 1e-3, 5e-2, 2e-2, 0.25
LR, WD = 1e-3, 1e-5  # config/InstanceRefer.yaml's Adam
TRAIN_LAUNCHES = {"gather_conv": 34, "subm_conv_bwd": 16, "conv_dw": 10}  # per train step
STEM_LAUNCHES = 2  # of K1's and of K3's per train step: the two stems, on the stem kernels
LIST_LAUNCHES = 8  # of the list pass and of the dX over its lists per train step: the downs
# an H100 SXM's dense peaks at 700 W: bf16 on the tensor cores, f32 outside
# them (TF32 is off), and device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10) -> float:
    fn()  # warm
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dt):
    """(least ms the card could take, what bounds it): flops over the peak
    of the type or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_text(kernel: str, path: str, v_out: int, k: int, cin: int, cout: int,
              out_dtype, dev) -> str:
    """The plan a K1, K2 or K3 launch on the tensor-core route takes
    (``gather_conv.tc_plan``; K2's dX and ``conv_bwd.dw_plan``; K3's
    ``conv_bwd.dw_list_splits``), as text; empty on the other routes."""
    from instancerefer_tpu_torch.ops.conv_bwd import dw_list_splits, dw_plan
    from instancerefer_tpu_torch.ops.gather_conv import sm_count, tc_plan

    if path != "tensor_core" or v_out == 0:
        return ""
    sms = sm_count(dev)
    if kernel == "K3":
        return f" plan per-offset lists, {dw_list_splits(v_out, k, cin, cout, sms)} splits a list"
    if kernel == "K2":
        p, d = tc_plan(v_out, k, cout, cin, torch.float32, sms), dw_plan(v_out, k, cin, cout, sms)
        return (f" plan dX {p.bm} rows x cluster {p.cluster} ({p.offsets_per_block} offsets a "
                f"block), dW G={d.group} splits={d.splits}")
    p = tc_plan(v_out, k, cin, cout, out_dtype, sms)
    return f" plan {p.bm} rows x cluster {p.cluster} ({p.offsets_per_block} offsets a block)"


def im2col(rows, nbr):
    """One index gather of ``rows`` by ``nbr`` (-1: a zero row) into
    [V, K * C]; the table and indices are set up outside the timing."""
    table = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    safe = torch.where(nbr >= 0, nbr, rows.shape[0]).long().reshape(-1)
    return lambda: table.index_select(0, safe).view(nbr.shape[0], -1)


class Totals:
    """Per-kernel sums over the shapes of the main path's configuration."""

    def __init__(self):
        self.worst = 0.0
        self.ms = self.plain_ms = self.im2col_ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, t_k, t_p, t_i, flops, nb, dt):
        self.ms += t_k
        self.plain_ms += t_p
        self.im2col_ms += t_i
        self.ops_ms += flops / PEAK_FLOPS[dt] * 1e3
        self.bytes_ms += nb / PEAK_BYTES_PER_S * 1e3

    def entry(self):
        return {"max_abs_err": self.worst, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": max(self.ops_ms, self.bytes_ms),
                "bound_by": "operations" if self.ops_ms >= self.bytes_ms else "bytes",
                "library_ms": None, "im2col_ms": self.im2col_ms or None}


# a stem kernel's mangled name (template arguments, if any)
STEM_KERNEL = re.compile(r"(stem_\w*?kernel)(I\w*?E)?E")


# profiles of one step, at most, before a disagreement with the launches
# counted fails it: the profiler can lose device records (one profile of
# the use_multiview train replay kept 4073 of its 4296, another missed 4
# of K1's 34 launches), while a step runs the same kernels each time
PROFILE_TRIES = 3


def device_records(prof) -> int:
    """The device's records (kernels, copies, fills) the profiler kept."""
    from torch.autograd import DeviceType

    return sum(ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False) for ev in prof.events())


def profile_until(label: str, run, activities, disagreement):
    """``run`` under ``torch.profiler`` until ``disagreement(prof)``, which
    holds the profile against what the step launched, returns None; then
    that profile.  A profile that disagrees is logged and taken again, up
    to PROFILE_TRIES profiles; it must have kept fewer device records than
    the one that agrees, or the disagreement was not the profiler's lost
    records and fails the check, as a disagreement in every profile does."""
    from torch.profiler import profile

    lossy = []
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        what = disagreement(prof)
        if what is None:
            kept = device_records(prof)
            if any(n >= kept for n in lossy):
                raise AssertionError(f"{label}: a profile that disagreed ({lossy} device "
                                     f"records) kept no fewer than the one that agreed ({kept})")
            return prof
        lossy.append(device_records(prof))
        log(f"[profile] {label}: profile {attempt} of {PROFILE_TRIES} disagrees: {what}; "
            f"{lossy[-1]} device records kept")
    raise AssertionError(f"{label}: {PROFILE_TRIES} profiles, each disagrees: {what}")


def profile_kernels(label: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler``: the device time of the
    sparse-conv kernels by wrapper, of all device work, and the wall time
    (the profiler's own cost included), logged as a ``[profile]`` line.
    The launches the profiler saw (``launch_groups``) must equal what the
    wrappers' counters added over the call: under a graph's replay, which
    runs no Python, the counters add what the capture counted.  A profile
    that saw fewer is taken again (``profile_until``); more fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    timing = {}

    def run():
        before = _launch_counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timing["wall"] = (time.perf_counter() - t0) * 1e3
        timing["counted"] = {k: n - before[k] for k, n in _launch_counts().items()}

    def disagreement(prof):
        counted = timing["counted"]
        kinds = [kernel for kernel, _ in launch_groups(prof)]
        seen = {k: kinds.count(kernel) for k, kernel in zip(counted, ("K1", "K2", "K3"))}
        timing["seen"] = seen
        if any(seen[k] > counted[k] for k in counted):
            raise AssertionError(f"{label}: the counters added {counted}, the profiler saw {seen}")
        return None if seen == counted else f"the counters added {counted}, the profiler saw {seen}"

    prof = profile_until(label, run, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         disagreement)
    wall, seen = timing["wall"], timing["seen"]
    by_family = {name: 0.0 for name, _ in KERNEL_FAMILIES}
    device = 0.0
    for ev in prof.key_averages():
        # an op's row repeats its kernels' time; an annotation's (Adam's
        # step, eagerly) spans the kernels inside it, gaps included
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        t = ev.self_device_time_total / 1e3
        device += t
        family = next((name for name, pat in KERNEL_FAMILIES if pat.search(ev.key)), None)
        if family is not None:
            by_family[family] += t
    sparse = sum(by_family.values())
    log(f"[profile] {label}: sparse-conv kernels {sparse:.2f} ms (" + ", ".join(
        f"{k} {v:.2f}" for k, v in by_family.items()) + f"); device busy {device:.2f} ms of "
        f"{wall:.2f} ms wall under the profiler, idle {1 - device / wall:.1%}; launches seen "
        "by the profiler " + ", ".join(f"{k} {n}" for k, n in seen.items()) + ", counted "
        "the same")
    if sparse == 0:
        raise AssertionError(f"{label}: the profiler saw no sparse-conv kernel")


def make_model(spec, seed: int):
    """Random weights from a generator; BN running statistics moved off
    their defaults so the folded epilogue is exercised."""
    from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer

    gen = torch.Generator().manual_seed(seed)
    model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.running_mean.shape[0]
                m.running_mean += 0.02 * torch.randn(n, generator=gen)
                m.running_var *= 0.5 + torch.rand(n, generator=gen)
    return model.eval()


def run_slice(model, dd, mean_size):
    from instancerefer_tpu_torch.train.evaluate import get_eval
    from instancerefer_tpu_torch.train.losses import get_loss

    with torch.no_grad():
        return get_eval(get_loss(model(dd), mean_size))


def phase_kernel(batch, dev):
    from instancerefer_tpu_torch.ops import sparse
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv, pad_channels, route

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = (
        ("scene stem", "scene_nbr3_0", "scene_nbr3_0", FEAT_DIM, WIDTHS[0]),
        ("instance stem", "inst_nbr3_0", "inst_nbr3_0", FEAT_DIM, WIDTHS[0]),
        ("scene stage1 down", "scene_down_1", "scene_nbr3_0", 32, 64),
        ("scene stage2 residual", "scene_nbr3_2", "scene_nbr3_2", 128, 128),
        ("scene stage3 residual", "scene_nbr3_3", "scene_nbr3_3", 128, 128),
        ("scene stage4 residual", "scene_nbr3_4", "scene_nbr3_4", 128, 128),
    )
    totals = Totals()
    for name, key, in_key, cin, cout in shapes:
        nbr = torch.from_numpy(np.ascontiguousarray(batch[key], np.int32)).to(dev)
        v_in = batch[in_key].shape[0]
        k = nbr.shape[1]
        nnz = int((nbr >= 0).sum())
        for dt in (torch.float32, torch.bfloat16):
            feats = torch.randn(v_in, cin, device=dev, generator=gen).to(dt)
            # the kernel takes the rows the main path gives it: on the stem
            # route padded to 16 bytes (as ops/sparse_conv.stem_input does)
            fk = pad_channels(feats) if route(dt, cin, dev) == "stem_wide" else feats
            w = (torch.randn(k, cin, cout, device=dev, generator=gen) / (k * cin) ** 0.5).to(dt)
            gather = im2col(feats, nbr)
            w2 = w.reshape(k * cin, cout)
            t_i = median_ms(lambda: torch.mm(gather(), w2))
            for epi in (False, True):
                sc = (0.5 + torch.rand(cout, device=dev, generator=gen)) if epi else None
                bi = 0.1 * torch.randn(cout, device=dev, generator=gen) if epi else None
                got = gather_conv(fk, nbr, w, sc, bi, relu=epi)
                ref = sparse.gather_conv(feats, nbr, w, sc, bi, relu=epi)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = KERNEL_TOL[dt] * max(scale, 1e-30)
                t_k = median_ms(lambda: gather_conv(fk, nbr, w, sc, bi, relu=epi))
                t_p = median_ms(lambda: sparse.gather_conv(feats, nbr, w, sc, bi, relu=epi))
                flops = 2 * nnz * cin * cout
                nb = nbytes(feats, nbr, w, got) + (2 * cout * 4 if epi else 0)
                b_ms, b_by = bound(flops, nb, dt)
                path = route(dt, cin, dev)
                log(f"[kernel] {name} V_out={nbr.shape[0]} K={k} {cin}->{cout} "
                    f"{str(dt)[6:]} epilogue={epi} route={path}"
                    f"{plan_text('K1', path, nbr.shape[0], k, cin, cout, dt, dev)}: max_abs={err:.3e} "
                    f"max_rel={err / max(scale, 1e-30):.3e} "
                    f"(tol {KERNEL_TOL[dt]:g} x max|ref|={scale:.3f}) "
                    f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by}: "
                    f"{flops / 1e9:.2f} GFLOP, {nb / 1e6:.1f} MB) library_ms=none (no single "
                    f"PyTorch call) im2col_ms={t_i:.4f}")
                if not err <= tol:
                    raise AssertionError(f"gather_conv disagrees with its twin at {name} {dt} epilogue={epi}")
                totals.worst = max(totals.worst, err)
                if dt == torch.bfloat16 and epi:  # the main path's configuration
                    totals.add(t_k, t_p, t_i, flops, nb, dt)
            del gather
    return totals


def phase_parity(spec, dev):
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    set_compute_dtype(None)
    batch = make_batch(2, spec, seed=3, mean_size_arr=MEAN_SIZE, **SCENE_KW)
    cpu_model = make_model(spec, seed=1)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    cpu = run_slice(cpu_model, batch_to_torch(batch, spec, "cpu"), ms)
    gpu = run_slice(gpu_model, batch_to_torch(batch, spec, dev), ms.to(dev))
    torch.cuda.synchronize()
    cand = cpu["cand_mask"]
    checks = {
        "lang_scores": None, "attribute_scores": cpu["score_mask"],
        "relation_scores": cand, "scene_scores": cand, "seg_scores": None, "loss": None,
    }
    for key, mask in checks.items():
        a, b = gpu[key].cpu(), cpu[key]
        if mask is not None:
            a, b = a[mask], b[mask]
        err = (a - b).abs()
        bound = SLICE_ATOL + SLICE_RTOL * b.abs()
        log(f"[parity] {key}: {b.numel()} valid entries, max_abs={err.max().item():.3e} "
            f"(atol {SLICE_ATOL:g} + rtol {SLICE_RTOL:g})")
        if b.numel() and not bool((err <= bound).all()):
            raise AssertionError(f"card and CPU disagree on {key}")
    n_scored = int(cpu["score_mask"].sum())
    if n_scored == 0:
        raise AssertionError("parity batch has no scored candidates")


def static_inputs(graphs, phase, dd):
    """The static inputs of the graph that ``dd``'s key replays (which hold
    ``dd``'s values once it has been stepped): repeats of the same batch
    replay with no copy, as the solver's ``load`` does."""
    return graphs.graphs[graphs.key(phase, dd["lang_feat"].shape[1])].inputs


def phase_full(spec, dev, dds, model, label="full"):
    """The eval step at B = BATCH through its CUDA graph (``StepGraphs``,
    the eval CLI's path): the first batch warms up and captures, the
    repeats replay it, each later batch is copied into its inputs."""
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    set_compute_dtype("bfloat16")
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    graphs = StepGraphs(model, None, ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    repeats = 5

    gather_conv.launches = 0
    outs = [graphs.eval_step(dds[0])[1]]  # warm-up and capture
    static = static_inputs(graphs, "eval", dds[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        outs.append(graphs.eval_step(static)[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs += [graphs.eval_step(dd)[1] for dd in dds[1:]]
    torch.cuda.synchronize()
    launches = gather_conv.launches
    n_forward = len(outs)

    b, c = BATCH, spec.max_candidates
    shapes = {"lang_scores": (b, spec.num_classes), "attribute_scores": (b, c),
              "relation_scores": (b, c), "scene_scores": (b, c), "seg_scores": (b, 9),
              "loss": (), "ref_iou": (b,)}
    for out in outs:
        for key, shape in shapes.items():
            if tuple(out[key].shape) != shape or not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"{key}: shape {tuple(out[key].shape)} or non-finite values")
        iou = out["ref_iou"]
        if not bool(((iou >= 0) & (iou <= 1)).all()):
            raise AssertionError("ref_iou outside [0, 1]")
    if launches != CONVS_PER_FORWARD * n_forward:
        raise AssertionError(f"{launches} kernel launches for {n_forward} forwards")
    peak = torch.cuda.max_memory_allocated(dev)
    sps = BATCH * repeats / dt
    profile_kernels(f"{label} eval step B={BATCH} Cin={spec.feat_dim} bf16, graph replay",
                    lambda: graphs.eval_step(static))
    for i, out in enumerate(outs[-len(dds):]):
        log(f"[{label}] batch {i}: loss={out['loss'].item():.4f} "
            f"ref_acc_mean={out['ref_acc_mean'].item():.4f} "
            f"mean_ref_iou={out['ref_iou'].mean().item():.4f} num_missed={int(out['num_missed'])}")
    log(f"[{label}] B={BATCH} Cin={spec.feat_dim} bf16: {n_forward} forwards, {launches} kernel launches "
        f"({launches // n_forward} per forward); eval {sps:.2f} scenes/s "
        f"(forward+get_loss+get_eval, graph replays, mean over {repeats} repeats, "
        f"{dt / repeats * 1e3:.2f} ms/batch); {graphs.captures} capture; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    set_compute_dtype(None)
    return launches


def _max_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def check_lists(label, nbr, nnz, totals):
    """K3's list pass alone (``conv_bwd.dw_lists``) against its plain
    version, every entry equal; its CUDA-event median beside the plain
    version's and the bound (the map read once, an int32 written a valid
    entry and a count an offset), added to ``totals``."""
    from instancerefer_tpu_torch.ops import conv_bwd

    (v_out, k), dt = nbr.shape, torch.bfloat16
    got, want = conv_bwd.dw_lists(nbr), conv_bwd.dw_lists_plain(nbr)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"the list pass disagrees with its plain version at {label}")
    work = torch.empty(conv_bwd.dw_list_workspace(v_out), dtype=torch.int32, device=nbr.device)
    t_k = median_ms(lambda: conv_bwd.dw_lists_into(nbr, work))
    t_p = median_ms(lambda: conv_bwd.dw_lists_plain(nbr))
    nb = nbytes(nbr) + 4 * (nnz + k)
    b_ms, b_by = bound(0, nb, dt)
    log(f"[list] dw_lists {label} V_out={v_out} K={k} valid={nnz}: lists and counts equal to "
        f"the plain version's; kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}: {nb / 1e6:.1f} MB) library_ms=none (no single PyTorch call)")
    totals.add(t_k, t_p, 0.0, 0, nb, dt)


def check_down_dx(label, down, up8, cin, cout, gen, totals):
    """The down conv's dX over the lists of its map (``conv_bwd.down_dx``,
    bf16 in, f32 out) against its plain version (``down_dx_plain`` over the
    same lists in the kernel's split and tile order) to DX_TOL of the
    largest value, two launches bit-identical,
    the rows no entry names exactly 0; its CUDA-event median beside the
    plain version's, the im2col yardstick over ``up8`` and the bound (g,
    ``up8`` and W read once, dX written once; the valid entries' flops),
    added to ``totals``.  The list pass runs outside the timing, as the
    main path shares it with K3."""
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import route, sm_count

    dt = torch.bfloat16
    (v_out, k), v_in = down.shape, up8.shape[0]
    g = torch.randn(v_out, cout, device=down.device, generator=gen).to(dt)
    w = (torch.randn(k, cin, cout, device=down.device, generator=gen) / (k * cin) ** 0.5).to(dt)
    work = conv_bwd.down_lists(down)
    lists, counts = conv_bwd.dw_lists_plain(down)
    splits = conv_bwd.dx_list_splits(v_out, k, cin, cout, sm_count(down.device))
    dx = conv_bwd.down_dx(g, down, up8, w, work)
    again = conv_bwd.down_dx(g, down, up8, w, work)
    ref = conv_bwd.down_dx_plain(g, down, w, lists, counts, v_in, splits)
    torch.cuda.synchronize()
    err, scale = _max_err(dx, ref)
    uncovered = (up8 < 0).all(1)
    nnz = int((down >= 0).sum())
    log(f"[down-dx] {label} dX V_in={v_in} V_out={v_out} {cout}->{cin} valid={nnz} "
        f"uncovered rows={int(uncovered.sum())}: max_abs={err:.3e} "
        f"max_rel={err / max(scale, 1e-30):.3e} (tol {DX_TOL:g} x max|ref|={scale:.3f})")
    if dx.dtype != torch.float32 or not err <= DX_TOL * max(scale, 1e-30):
        raise AssertionError(f"down_dx disagrees with its plain version at {label}")
    if not torch.equal(dx, again):
        raise AssertionError(f"down_dx at {label}: dX differs between two launches")
    if dx[uncovered].any():
        raise AssertionError(f"down_dx at {label}: a row no entry names is not 0")
    gather, wt = im2col(g, up8), w.transpose(1, 2).reshape(k * cout, cin)
    t_k = median_ms(lambda: conv_bwd.down_dx(g, down, up8, w, work))
    t_p = median_ms(lambda: conv_bwd.down_dx_plain(g, down, w, lists, counts, v_in))
    t_i = median_ms(lambda: torch.mm(gather(), wt))
    flops, nb = 2 * nnz * cin * cout, nbytes(g, up8, w, dx)
    b_ms, b_by = bound(flops, nb, dt)
    log(f"[down-dx] {label} route={route(dt, cin, down.device)} plan per-offset lists, "
        f"{splits} blocks a list: "
        f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nb / 1e6:.1f} MB) library_ms=none (no single PyTorch call) "
        f"im2col_ms={t_i:.4f}; dX bit-identical across two launches")
    totals.worst = max(totals.worst, err)
    totals.add(t_k, t_p, t_i, flops, nb, dt)


def phase_bwd_kernels(batch, dev):
    """K3 and K2 against their twins, K3's list pass at the downs and the
    down convs' dX over the lists against their plain versions; returns
    per kernel (and ``dw_lists``, ``down_dx``) the ``Totals`` of its bf16
    shapes (the worst |err| of all)."""
    from instancerefer_tpu_torch.ops import conv_bwd, sparse, voxelize
    from instancerefer_tpu_torch.ops.gather_conv import pad_channels, route

    def imap(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def rows(prefix, s):
        return batch[f"{prefix}_nbr3_{s}"].shape[0]

    # name: (kernel, twin, names of the outputs, their tolerances)
    kernels = {
        "conv_dw": (conv_bwd.conv_dw, sparse.conv_dw, ("dW",), (DW_TOL,)),
        "subm_conv_bwd": (conv_bwd.subm_conv_bwd, sparse.subm_conv_bwd, ("dX", "dW"),
                          (DX_TOL, DW_TOL)),
    }
    # (kernel, label, map, rows of the gathered input, cin, cout): K3 at
    # every shape of a train step (one launch each), then K2
    cases = []
    for enc, p in ENCODERS:
        cases.append(("conv_dw", f"{enc} stem", imap(batch[f"{p}_nbr3_0"]), rows(p, 0),
                      FEAT_DIM, WIDTHS[0]))
        cases += [("conv_dw", f"{enc} stage{s} down", imap(batch[f"{p}_down_{s}"]),
                   rows(p, s - 1), WIDTHS[s - 1], WIDTHS[s]) for s in range(1, 5)]
    # K2 at every residual of both encoders (each dX plan at B = 32: 64-row
    # tiles alone at stages 1-2, in clusters of 2 at stage 3 and of 4 at
    # stage 4)
    cases += [("subm_conv_bwd", f"{enc} stage{s} residual", imap(batch[f"{p}_nbr3_{s}"]),
               rows(p, s), WIDTHS[s], WIDTHS[s]) for enc, p in ENCODERS for s in range(1, 5)]
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {name: Totals() for name in (*kernels, "dw_lists", "down_dx")}
    for name, label, nbr, v_in, cin, cout in cases:
        kern, twin, outs, tols = kernels[name]
        v_out, k = nbr.shape
        nnz = int((nbr >= 0).sum())
        if name == "conv_dw" and route(torch.bfloat16, cin, dev) == "tensor_core":
            check_lists(label, nbr, nnz, res["dw_lists"])
        for dt in (torch.float32, torch.bfloat16):
            def rnd(*shape, scale=1.0):
                return (scale * torch.randn(*shape, device=dev, generator=gen)).to(dt)

            # flops of the map's valid entries, and the im2col yardstick: one
            # gather into [V, K * C] and the products of the same function
            if name == "conv_dw":
                args = (rnd(v_in, cin), nbr, rnd(v_out, cout))
                gather = im2col(args[0], nbr)
                flops = 2 * nnz * cin * cout

                def yardstick():
                    return torch.mm(gather().t(), args[2])
            else:
                args = (rnd(v_out, cin), nbr, rnd(v_out, cout), rnd(k, cin, cout, scale=(k * cin) ** -0.5))
                gather = im2col(args[2], nbr)
                wd = args[3].flip(0).transpose(1, 2).reshape(k * cout, cin)  # W[K-1-k]^T
                flops = 4 * nnz * cin * cout

                def yardstick():
                    cols = gather()
                    return torch.mm(cols, wd), torch.mm(args[0].t(), cols)

            # the kernel takes the rows the main path gives it: on the stem
            # route padded to 16 bytes (as ops/sparse_conv.stem_input does)
            kargs, kw = args, {}
            if route(dt, cin, dev) == "stem_wide":
                kargs, kw = (pad_channels(args[0]), *args[1:]), {"cin": cin}

            def run(fn, a, kw):
                out = fn(*a, **kw)
                return out if isinstance(out, tuple) else (out,)

            got, ref = run(kern, kargs, kw), run(twin, args, {})
            again = run(kern, kargs, kw) if outs[-1] == "dW" else None
            torch.cuda.synchronize()
            if again is not None and not torch.equal(got[-1], again[-1]):
                raise AssertionError(f"{name} at {label} {dt}: dW differs between two launches")
            t_k = median_ms(lambda: kern(*kargs, **kw))
            t_p = median_ms(lambda: twin(*args))
            t_i = median_ms(yardstick)
            nb = nbytes(*args, *got)
            b_ms, b_by = bound(flops, nb, dt)
            for out_name, g, r, tol in zip(outs, got, ref, tols):
                err, scale = _max_err(g, r)
                log(f"[bwd-kernel] {name} {label} {out_name} V_out={v_out} K={k} {cin}->{cout} "
                    f"{str(dt)[6:]}: max_abs={err:.3e} max_rel={err / max(scale, 1e-30):.3e} "
                    f"(tol {tol:g} x max|ref|={scale:.3f})")
                if g.dtype != torch.float32 or not err <= tol * max(scale, 1e-30):
                    raise AssertionError(f"{name} disagrees with its twin at {label} {dt} {out_name}")
                res[name].worst = max(res[name].worst, err)
            path = route(dt, cin, dev)
            plan = plan_text({"conv_dw": "K3", "subm_conv_bwd": "K2"}[name], path, v_out, k, cin,
                             cout, torch.float32, dev)
            log(f"[bwd-kernel] {name} {label} {str(dt)[6:]} route={path}{plan}: "
                f"kernel_ms={t_k:.4f} "
                f"plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, "
                f"{nb / 1e6:.1f} MB) library_ms=none (no single PyTorch call) im2col_ms={t_i:.4f}"
                + ("" if again is None else "; dW bit-identical across two launches"))
            if dt == torch.bfloat16:  # the main path's type
                res[name].add(t_k, t_p, t_i, flops, nb, dt)
            del gather
    for enc, p in ENCODERS:  # the down convs' dX over the lists of their maps
        for s in range(1, 5):
            up8 = imap(voxelize.build_up8(batch[f"{p}_uprow_{s}"], batch[f"{p}_upk_{s}"]))
            check_down_dx(f"{enc} stage{s} down", imap(batch[f"{p}_down_{s}"]), up8,
                          WIDTHS[s - 1], WIDTHS[s], gen, res["down_dx"])
    return res


def phase_train_parity(spec, dev, batch=None):
    """Train parity, card vs CPU, on ``batch`` (default: 2 synthetic
    scenes of ``spec``, whose stems take Cin 7)."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    set_compute_dtype(None)
    torch.backends.cudnn.deterministic = True
    if batch is None:
        batch = make_batch(2, spec, seed=3, mean_size_arr=MEAN_SIZE, **SCENE_KW)
    log(f"[train-parity] {len(batch['lang_len'])} scenes, stems Cin={spec.feat_dim}")
    cpu_model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                              generator=torch.Generator().manual_seed(4), dropout_override=0.0)
    models = {"cpu": cpu_model, "gpu": copy.deepcopy(cpu_model).to(dev)}
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    runs = {}
    for side, model in models.items():
        device = "cpu" if side == "cpu" else dev
        dd = batch_to_torch(batch, spec, device)
        opt = make_optimizer(model.parameters(), LR, WD)
        metrics, _ = train_step(model, opt, dd, ms.to(device))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running" in n}
        train_step(model, opt, dd, ms.to(device))
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        runs[side] = (float(metrics["loss"]), grads, stats, params)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (c_loss, c_grads, c_stats, c_params), (g_loss, g_grads, g_stats, g_params) = runs["cpu"], runs["gpu"]
    check_step("train-parity", ("cpu", "gpu"), (c_loss, c_grads, c_stats), (g_loss, g_grads, g_stats))
    total, tight, count = 0.0, 0, 0
    for n in c_params:
        diff = (g_params[n] - c_params[n]).abs()
        if not bool((diff <= 2.5 * 2 * LR + 1e-3 * c_params[n].abs()).all()):
            raise AssertionError(f"{n} after 2 Adam steps: max |diff| {diff.max().item():.3e}")
        total += diff.sum().item()
        tight += int((diff <= 0.1 * LR).sum())
        count += diff.numel()
    log(f"[train-parity] parameters after 2 Adam steps: mean |diff| {total / count / LR:.4f} lr "
        f"(limit {ADAM_MEAN:g}), {tight / count:.4f} of {count} elements within 0.1 lr, "
        f"all within 2.5 x the summed lr + 1e-3 |p|")
    if not total <= ADAM_MEAN * LR * count:
        raise AssertionError("card and CPU parameters drift apart over 2 Adam steps")


def check_step(label, names, ref, got):
    """One train step's (loss, gradients, running statistics) against the
    reference step's: the loss to LOSS_RTOL, the gradients in L2 per layer
    and overall (GRAD_LAYER, GRAD_ALL), the statistics to STATS_RTOL.
    ``names``: (the reference's, the other's)."""
    (c_loss, c_grads, c_stats), (g_loss, g_grads, g_stats) = ref, got
    sides = f"{names[1]} and {names[0]}"
    log(f"[{label}] loss {names[0]}={c_loss:.6f} {names[1]}={g_loss:.6f} (rtol {LOSS_RTOL:g})")
    if not abs(g_loss - c_loss) <= LOSS_RTOL * abs(c_loss):
        raise AssertionError(f"{sides} disagree on the train loss")
    layer_norm = {}
    for n, g in c_grads.items():
        layer = n.rsplit(".", 1)[0]
        layer_norm[layer] = max(layer_norm.get(layer, 0.0), g.norm().item())
    if max(layer_norm.values()) == 0:
        raise AssertionError("all gradients are zero")
    worst_rel, worst_abs, num, den = (0.0, ""), (0.0, ""), 0.0, 0.0
    for n, c in c_grads.items():
        d = (g_grads[n] - c).norm().item()
        rel = d / max(layer_norm[n.rsplit(".", 1)[0]], 1e-30)
        worst_rel = max(worst_rel, (rel, n))
        worst_abs = max(worst_abs, ((g_grads[n] - c).abs().max().item(), n))
        num, den = num + d * d, den + c.norm().item() ** 2
        if not rel <= GRAD_LAYER:
            raise AssertionError(f"{sides} disagree on the gradient of {n}: "
                                 f"L2 error {rel:.3e} of its layer's gradient norm")
    overall = (num / den) ** 0.5
    log(f"[{label}] {len(c_grads)} parameter gradients: L2 error overall {overall:.3e} "
        f"(limit {GRAD_ALL:g}), largest per layer {worst_rel[0]:.3e} at {worst_rel[1]} "
        f"(limit {GRAD_LAYER:g}); largest |err| {worst_abs[0]:.3e} at {worst_abs[1]}")
    if not overall <= GRAD_ALL:
        raise AssertionError(f"{sides} gradients disagree overall")
    for n in c_stats:
        err = (g_stats[n] - c_stats[n]).abs()
        if not bool((err <= STATS_RTOL * c_stats[n].abs() + 1e-5).all()):
            raise AssertionError(f"{sides} disagree on {n} (max |err| {err.max().item():.3e})")
    log(f"[{label}] {len(c_stats)} running statistics agree (rtol {STATS_RTOL:g}, atol 1e-5)")


def phase_train(spec, dev, dds, label="train", repeats=5, profile=True):
    """The train step at B = BATCH through its CUDA graph (``StepGraphs``,
    the solver's path on one card): a warm-up that also captures, the timed
    replays of the same batch, then each later batch copied into the
    graph's inputs."""
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    set_compute_dtype("bfloat16")
    model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                          generator=torch.Generator().manual_seed(5)).to(dev)
    opt = make_optimizer(model.parameters(), LR, WD)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    graphs = StepGraphs(model, opt, ms)
    counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                "conv_dw": conv_bwd.conv_dw}
    stems = {"gather_conv": gather_conv, "conv_dw": conv_bwd.conv_dw}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    results = []

    def check(metrics, out, grads=True):
        bad = [n for n, p in model.named_parameters() if grads and (
            p.grad is None or not bool(torch.isfinite(p.grad).all()))]
        if bad or not bool(torch.isfinite(metrics["loss"])):
            raise AssertionError(f"non-finite loss or gradients: {bad[:5]}")
        iou = out["ref_iou"]
        if iou.shape != (BATCH,) or not bool(((iou >= 0) & (iou <= 1)).all()):
            raise AssertionError("ref_iou outside [0, 1]")
        results.append({k: float(v) for k, v in metrics.items()})

    for f in (*counters.values(), conv_bwd.dw_lists, conv_bwd.down_dx):
        f.launches = 0
    for f in stems.values():
        f.stem_launches = 0
    check(*graphs.train_step(dds[0]))  # warm-up and capture
    static = static_inputs(graphs, "train", dds[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [graphs.train_step(static) for _ in range(repeats)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, (metrics, out) in enumerate(timed):  # the gradients are the last step's
        check(metrics, out, grads=i == repeats - 1)
    del timed
    for dd in dds[1:]:
        check(*graphs.train_step(dd))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    stem_launches = {k: f.stem_launches for k, f in stems.items()}
    n_steps = 1 + repeats + len(dds) - 1
    for k, per_step in TRAIN_LAUNCHES.items():
        if launches[k] != per_step * n_steps:
            raise AssertionError(f"{k}: {launches[k]} launches in {n_steps} train steps, "
                                 f"want {per_step} per step")
    for k, n in stem_launches.items():  # both stems, on the stem kernels
        if n != STEM_LAUNCHES * n_steps:
            raise AssertionError(f"{k}: {n} stem-kernel launches in {n_steps} train steps")
    # the list pass, once in each down's backward, and the dX over its
    # lists there (counted among K1's launches too)
    for k, f in (("dw_lists", conv_bwd.dw_lists), ("down_dx", conv_bwd.down_dx)):
        launches[k] = f.launches
        if launches[k] != LIST_LAUNCHES * n_steps:
            raise AssertionError(f"{k}: {launches[k]} launches in {n_steps} train steps, want "
                                 f"{LIST_LAUNCHES} per step")
    peak = torch.cuda.max_memory_allocated(dev)
    if profile:
        profile_kernels(f"{label} step B={BATCH} Cin={spec.feat_dim} bf16, graph replay",
                        lambda: graphs.train_step(static))
    for i, r in enumerate(results):
        log(f"[{label}] step {i}: loss={r['loss']:.4f} ref_loss={r['ref_loss']:.4f} "
            f"lang_loss={r['lang_loss']:.4f} seg_loss={r['seg_loss']:.4f} ref_acc={r['ref_acc']:.4f}")
    log(f"[{label}] B={BATCH} Cin={spec.feat_dim} bf16: {n_steps} train steps, launches per "
        "step " + ", ".join(f"{k} {launches[k] // n_steps}" for k in counters) +
        " (" + ", ".join(f"{k} {stem_launches[k] // n_steps} at the stems" for k in stems) +
        f"); train {BATCH * repeats / dt:.2f} scenes/s (forward+get_loss+backward+Adam+get_eval, "
        f"graph replays, mean over {repeats} steps, {dt / repeats * 1e3:.2f} ms/step); "
        f"{graphs.captures} capture; peak device memory {peak / 2**20:.1f} MiB")
    set_compute_dtype(None)
    return launches, stem_launches


REPO = os.path.dirname(os.path.abspath(__file__))
# ScanRefer has 65-67 descriptions a scene in each split; the fake root has 64
CLI_BATCHES = {"train": 16, "val": 8}  # batches of BATCH a split
EVAL_LAUNCHES = {"gather_conv": CONVS_PER_FORWARD, "subm_conv_bwd": 0, "conv_dw": 0}
# the lr Adam applies in the CLI runs' epochs 1 and 2 (the milestone after
# epoch 1, rate 0.1): on a card a float32 tensor that the schedule
# multiplies by the rate in float32, as the JAX package's optax schedule
# does; the solver logs it as Adam holds it
LR_F32 = np.array([LR, np.float32(LR) * np.float32(0.1)], np.float32)
def cli_config_text(profile: str = os.path.join(REPO, "config", "band_profile.synthetic.yaml")
                    ) -> str:
    """``config/InstanceRefer.yaml`` with batch 32, 2 epochs, the lr milestone
    after epoch 1, an iter report every step, and the fitted caps of
    ``profile`` (default: the synthetic band profile's)."""
    text = open(os.path.join(REPO, "config", "InstanceRefer.yaml")).read()
    for old, new in (("batch_size: 64", f"batch_size: {BATCH}"), ("epoch: 25", "epoch: 2"),
                     ("lr_decay_step: [15, 20]", "lr_decay_step: [1]"), ("verbose: 20", "verbose: 1")):
        if text.count(old) != 1:
            raise AssertionError(f"config/InstanceRefer.yaml: {old!r} not found once")
        text = text.replace(old, new)
    if not text.rstrip().splitlines()[-1].startswith("  "):
        raise AssertionError("config/InstanceRefer.yaml no longer ends in its TPU section")
    return text + f"  band_profile: {profile}\n"


def _records(run: str):
    with open(os.path.join(run, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_cli():
    import warnings

    from instancerefer_tpu_torch.config import load_config
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.scripts import eval as eval_cli
    from instancerefer_tpu_torch.scripts import train as train_cli

    counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                "conv_dw": conv_bwd.conv_dw}
    root = tempfile.mkdtemp(prefix="cli_smoke_")
    try:
        t0 = time.perf_counter()
        write_fake_scanrefer(root, np.random.default_rng(0), CLI_BATCHES, BATCH)
        configs = {"main": cli_config_text()}
        configs["predicted"] = configs["main"].replace("use_gt_lang: True", "use_gt_lang: False") \
            .replace("epoch: 2", "epoch: 1")
        for name, text in configs.items():
            with open(os.path.join(root, f"{name}.yaml"), "w") as f:
                f.write(text)
        log(f"[cli] fake ScanRefer root ({len(CLI_SCENES['train'])} train and "
            f"{len(CLI_SCENES['val'])} val scenes, {CLI_BATCHES['train']} and "
            f"{CLI_BATCHES['val']} batches of {BATCH}) written in {time.perf_counter() - t0:.1f} s")

        def argv(config, log_dir):
            return ["--config", os.path.join(root, f"{config}.yaml"), "--log_dir", log_dir,
                    "--data_root", root, "--output_root", os.path.join(root, "outputs"),
                    "--device", "cuda"]

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the profile overrides the yaml's caps, on purpose
            spec = load_config(argv("main", "x")).batch_spec()
        for k, v in SPEC_KW.items():
            if getattr(spec, k) != v:
                raise AssertionError(f"the CLI config's {k} is {getattr(spec, k)}, want {v}")

        def drive(label, fn, args, want_per_step):
            """One CLI ``main`` with the launch counters set to 0 just before
            and read just after; ``want_per_step(result)`` gives the launches
            it must have made.  Its standard output is kept back, and shown
            if it fails."""
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = io.StringIO()
            try:
                with warnings.catch_warnings(), contextlib.redirect_stdout(out):
                    warnings.simplefilter("ignore")
                    result = fn(args)
            except BaseException:
                log(out.getvalue()[-4000:])
                raise
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            got = {k: f.launches for k, f in counters.items()}
            want = want_per_step(result)
            log(f"[cli] {label}: {wall:.1f} s wall, launches " +
                ", ".join(f"{k} {got[k]}" for k in counters))
            if got != want:
                raise AssertionError(f"{label}: launches {got}, want {want}")
            return result, wall

        def train_launches(epochs):
            def want(solver):
                n_train, n_val = solver.steps["train"], solver.steps["val"]
                if n_train != CLI_BATCHES["train"] * epochs or n_val != CLI_BATCHES["val"] * epochs:
                    raise AssertionError(f"{n_train} train and {n_val} val steps in {epochs} epochs")
                return {k: TRAIN_LAUNCHES[k] * n_train + EVAL_LAUNCHES[k] * n_val for k in counters}
            return want

        solver, train_wall = drive("train", train_cli.main, argv("main", "cli"), train_launches(2))
        run = solver.root
        for name in ("model_last.pth", "model.pth", "checkpoint.tar", "log.txt", "scalars.jsonl",
                     "best.txt", "info.json"):
            if not os.path.isfile(os.path.join(run, name)):
                raise AssertionError(f"train wrote no {name}")
        records = _records(run)
        bad = [r for r in records for k in ("loss", "ref_loss", "lang_loss", "seg_loss")
               if not np.isfinite(r[k])]
        per_epoch = CLI_BATCHES["train"]
        if bad or len(records) != 2 * (per_epoch + 1):
            raise AssertionError(f"{len(records)} records, non-finite losses in {bad[:2]}")
        lrs = [r["lr"] for r in records if r["phase"] == "train"]
        if lrs != [float(LR_F32[0])] * per_epoch + [float(LR_F32[1])] * per_epoch:
            raise AssertionError(f"lr per train step {lrs}, want {LR_F32.tolist()} exactly")

        n_val = CLI_BATCHES["val"] * BATCH
        _, eval_wall = drive("eval (cold)", eval_cli.main, argv("main", "cli"),
                             lambda _: {k: EVAL_LAUNCHES[k] * CLI_BATCHES["val"] for k in counters})
        scores = np.load(os.path.join(run, "scores.npz"))
        if len(scores["ref_iou"]) != n_val or not np.isfinite(scores["ref_iou"]).all():
            raise AssertionError("scores.npz: wrong length or non-finite ious")
        table, _ = drive("eval (cached)", eval_cli.main, argv("main", "cli"),
                         lambda _: {k: 0 for k in counters})
        if table["overall"]["overall"]["count"] != n_val:
            raise AssertionError("the cached table does not count every description")

        with open(os.path.join(root, "resume.yaml"), "w") as f:
            f.write(configs["main"].replace(
                "epoch: 2", f"epoch: 3\n  use_checkpoint: {os.path.basename(run)}"))
        resumed, _ = drive("train resumed", train_cli.main, argv("resume", "cli"),
                          train_launches(1))
        text = open(os.path.join(resumed.root, "log.txt")).read()
        first = _records(resumed.root)[0]
        if resumed.root == run or "epoch 3 starting" not in text or "epoch 2 starting" in text \
                or first["iter"] != 2 * per_epoch or first["lr"] != float(LR_F32[1]):
            raise AssertionError("the resumed run does not go on from epoch 3")
        drive("train use_gt_lang False", train_cli.main, argv("predicted", "clipred"),
              train_launches(1))

        text = open(os.path.join(run, "log.txt")).read()
        reports = {k: np.array([float(v) for v in
                                re.findall(rf"\[info\] mean_{k}_time: (\S+)s", text)])
                   for k in ("fetch", "fetch_load", "fetch_copy", "fetch_stage", "forward",
                             "backward", "eval", "iter")}
        if any(len(v) != 2 * per_epoch for v in reports.values()):
            raise AssertionError("the train log holds no iter report for every iteration")
        # an epoch's first fetch waits for the loader to start and for two batches
        steady = np.arange(2 * per_epoch) % per_epoch != 0
        log(f"[cli] train B={BATCH}: {BATCH / reports['iter'][steady].mean():.2f} scenes/s "
            f"per iteration (fetch + step) in the steady state, the mean of {steady.sum()} "
            f"iterations; {BATCH / reports['iter'].mean():.2f} over all {steady.size}; "
            f"{steady.size * BATCH / train_wall:.2f} over the CLI's wall time of "
            f"{train_wall:.2f} s (setup, validation and checkpoints included)")
        log("[cli] train iter report, steady-state means: " + ", ".join(
            f"{k} {v[steady].mean() * 1e3:.2f} ms" for k, v in reports.items())
            + "; each epoch's first iteration: " + ", ".join(
            f"fetch {f * 1e3:.1f} ms" for f in reports["fetch"][~steady]))
        log(f"[cli] eval B={BATCH}: {n_val / eval_wall:.2f} scenes/s end to end "
            f"({n_val} descriptions in {eval_wall:.2f} s: dataset, weights, host "
            f"pipeline, forwards and scores.npz)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        set_compute_dtype(None)


# ---------------------------------------------------------------- phase 9
# the stems' Cin of the two input configs (config.py's channel sum)
MV_WIDTHS = {"use_multiview": 135, "use_normal": 10}
# ENet, card vs CPU, f32 with TF32 off: |err| <= ENET_TOL x max|cpu|; the
# convolutions sum in other orders (cuDNN's algorithms vs the CPU's)
ENET_TOL = 1e-4
# projection, card vs CPU: the share of (point, pixel) index entries that
# may differ (float64 sums in another order can move a point across the
# frustum test's or a pixel's rounding boundary)
INDEX_DIFF = 1e-4
MV_POINTS, MV_FRAMES = 100000, 64  # a ScanNet mesh's vertices; frames around it
MV_COVERAGE = 0.5  # the least share of the points the frames must cover
MV_BATCHES = 3  # use_multiview batches of BATCH for the steps


def chunked_im2col(rows, nbr, chunk=65536):
    """The im2col yardstick in chunks of rows (the scene stem's at Cin 135
    is 8.5 GB in f32): (row spans, cols(c0) -> [span, K * C])."""
    table = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    safe = torch.where(nbr >= 0, nbr, rows.shape[0]).long()
    spans = [(c0, min(c0 + chunk, nbr.shape[0])) for c0 in range(0, nbr.shape[0], chunk)]

    def cols(c0, c1):
        return table.index_select(0, safe[c0:c1].reshape(-1)).view(c1 - c0, -1)
    return spans, cols


def phase_stem_widths(batch, dev):
    """K1 (with and without its epilogue) and K3 at both stems at Cin 10
    and 135 against their twins; returns {(wrapper, Cin): Totals} of the
    bf16 shapes (K1 with its epilogue).  The kernels take the rows the
    stems' main path gives them: on the stem route, padded to 16 bytes by
    ``pad_channels`` (as ``ops/sparse_conv.stem_input`` does, outside the
    timing); the twins and the bound take the [V, Cin] rows."""
    from instancerefer_tpu_torch.ops import conv_bwd, sparse
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv, pad_channels, route

    gen = torch.Generator(device=dev).manual_seed(9)
    res = {}
    for cin in sorted(MV_WIDTHS.values()):
        k1 = res["gather_conv", cin] = Totals()
        k3 = res["conv_dw", cin] = Totals()
        for enc, p in ENCODERS:
            nbr = torch.from_numpy(np.ascontiguousarray(batch[f"{p}_nbr3_0"], np.int32)).to(dev)
            (v, k), cout = nbr.shape, WIDTHS[0]
            flops = 2 * int((nbr >= 0).sum()) * cin * cout
            for dt in (torch.float32, torch.bfloat16):
                path = route(dt, cin, dev)
                if dt == torch.bfloat16 and path == "fma":
                    raise AssertionError(f"bf16 at Cin {cin} takes the FMA kernels")
                x = torch.randn(v, cin, device=dev, generator=gen).to(dt)
                xk = pad_channels(x) if path == "stem_wide" else x
                w = (torch.randn(k, cin, cout, device=dev, generator=gen) / (k * cin) ** 0.5).to(dt)
                g = torch.randn(v, cout, device=dev, generator=gen).to(dt)
                spans, cols = chunked_im2col(x, nbr)
                w2 = w.reshape(k * cin, cout)
                t_i1 = median_ms(lambda: torch.cat([cols(a, b) @ w2 for a, b in spans]))
                t_i3 = median_ms(lambda: sum(cols(a, b).t() @ g[a:b] for a, b in spans))
                tag = f"{enc} stem V_out={v} K={k} {cin}->{cout} {str(dt)[6:]} route={path}"
                for epi in (False, True):
                    sc = (0.5 + torch.rand(cout, device=dev, generator=gen)) if epi else None
                    bi = 0.1 * torch.randn(cout, device=dev, generator=gen) if epi else None
                    got = gather_conv(xk, nbr, w, sc, bi, relu=epi)
                    ref = sparse.gather_conv(x, nbr, w, sc, bi, relu=epi)
                    err, scale = _max_err(got, ref)
                    t_k = median_ms(lambda: gather_conv(xk, nbr, w, sc, bi, relu=epi))
                    t_p = median_ms(lambda: sparse.gather_conv(x, nbr, w, sc, bi, relu=epi))
                    nb = nbytes(x, nbr, w, got) + (2 * cout * 4 if epi else 0)
                    b_ms, b_by = bound(flops, nb, dt)
                    log(f"[stem-width] K1 {tag} epilogue={epi}: max_abs={err:.3e} "
                        f"(tol {KERNEL_TOL[dt]:g} x max|ref|={scale:.3f}) kernel_ms={t_k:.4f} "
                        f"plain_ms={t_p:.4f} bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} "
                        f"GFLOP, {nb / 1e6:.1f} MB) library_ms=none im2col_ms={t_i1:.4f}")
                    if not err <= KERNEL_TOL[dt] * max(scale, 1e-30):
                        raise AssertionError(f"K1 disagrees with its twin at {tag} epilogue={epi}")
                    k1.worst = max(k1.worst, err)
                    if dt == torch.bfloat16 and epi:
                        k1.add(t_k, t_p, t_i1, flops, nb, dt)
                dw = conv_bwd.conv_dw(xk, nbr, g, cin=cin)
                again = conv_bwd.conv_dw(xk, nbr, g, cin=cin)
                ref = sparse.conv_dw(x, nbr, g)
                torch.cuda.synchronize()
                if not torch.equal(dw, again):
                    raise AssertionError(f"K3 at {tag}: dW differs between two launches")
                err, scale = _max_err(dw, ref)
                t_k = median_ms(lambda: conv_bwd.conv_dw(xk, nbr, g, cin=cin))
                t_p = median_ms(lambda: sparse.conv_dw(x, nbr, g))
                nb = nbytes(x, nbr, g, dw)
                b_ms, b_by = bound(flops, nb, dt)
                log(f"[stem-width] K3 {tag}: max_abs={err:.3e} (tol {DW_TOL:g} x "
                    f"max|ref|={scale:.3f}) kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {nb / 1e6:.1f} MB) "
                    f"library_ms=none im2col_ms={t_i3:.4f}; dW bit-identical across two launches")
                if not err <= DW_TOL * max(scale, 1e-30):
                    raise AssertionError(f"K3 disagrees with its twin at {tag}")
                k3.worst = max(k3.worst, err)
                if dt == torch.bfloat16:
                    k3.add(t_k, t_p, t_i3, flops, nb, dt)
                del spans, cols
    return res


def random_enet(gen):
    """An ``Enet`` whose every tensor is drawn from ``gen``: convs normal at
    torch's default scale, BatchNorm affine and statistics moved off their
    defaults, PReLU slopes in [0, 0.5]; eval mode."""
    from instancerefer_tpu_torch.models.enet import Enet

    model = Enet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.5, 0.5, generator=gen)
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, (3.0 * m.weight[0].numel()) ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.2, generator=gen)
            elif isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.0, 0.5, generator=gen)
    return model.eval()


def phase_enet(dev):
    """ENet card vs CPU on 8 frames, frames/s at batches of 8 and 32; returns
    the features [MV_FRAMES, 128, 32, 41] of MV_FRAMES frames on the card."""
    from instancerefer_tpu_torch.models.enet import normalize_frame

    model = random_enet(torch.Generator().manual_seed(6))
    frames = np.random.default_rng(6).uniform(size=(MV_FRAMES, 256, 328, 3)).astype(np.float32)
    x = normalize_frame(torch.from_numpy(frames)).permute(0, 3, 1, 2).contiguous()
    gpu, xg = copy.deepcopy(model).to(dev), x.to(dev)
    with torch.no_grad():
        want = model(x[:8])
        got = gpu(xg[:8])
    torch.cuda.synchronize()
    for name, g, c, shape in zip(("logits", "features"), got, want,
                                 ((8, 41, 32, 41), (8, 128, 32, 41))):
        err, scale = _max_err(g.cpu(), c)
        log(f"[enet] {name} {tuple(g.shape)} card vs CPU (f32, TF32 off): max_abs={err:.3e} "
            f"(tol {ENET_TOL:g} x max|cpu|={scale:.3f})")
        if tuple(g.shape) != shape or not err <= ENET_TOL * scale:
            raise AssertionError(f"ENet {name}: card and CPU disagree")

    for b in (8, 32):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = median_ms(lambda: _enet_feats(gpu, xg[:b]))
        log(f"[enet] feature pass B={b} 256x328 f32: {ms:.3f} ms, {b / ms * 1e3:.1f} frames/s "
            f"(CUDA-event median of 10); peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return torch.cat([_enet_feats(gpu, xg[i:i + 32]) for i in range(0, MV_FRAMES, 32)])


def _enet_feats(model, x):
    with torch.no_grad():
        return model.features(x)


def _assignment(ind, n):
    """[n] pixel of each point in a frame's correspondence, -1 for none."""
    a = torch.full((n,), -1, dtype=torch.long)
    if ind is not None:
        c = int(ind[0][0])
        a[ind[0][1:1 + c].cpu()] = ind[1][1:1 + c].cpu()
    return a


def phase_projection(dev, feats):
    """A room of MV_POINTS surface points seen from MV_FRAMES poses, each
    frame's depth rendered with a z-buffer: the correspondences and the
    maxpool fusion of ``feats`` on the card against the CPU; returns the
    card's fused [MV_POINTS, 128] features as numpy."""
    from instancerefer_tpu_torch.data import projection as P
    from instancerefer_tpu_torch.scripts.project_multiview_features import projector

    rng = np.random.default_rng(7)
    points = P.room_scene(rng, MV_POINTS)
    poses = [P.look_at(rng.uniform([1.0, 1.0, 1.2], [5.0, 4.0, 1.8]),
                       rng.uniform([0.0, 0.0, 0.0], [6.0, 5.0, 1.5])) for _ in range(MV_FRAMES)]
    cpu_h, gpu_h = projector("cpu"), projector(dev)
    depths = [P.zbuffer_depth(points, pose, cpu_h).numpy() for pose in poses]
    n, pts = len(points), torch.from_numpy(points).to(dev)
    fused = {"cpu": P.FrameFeatureFuser(n, 128, "maxpool", "cpu"),
             "gpu": P.FrameFeatureFuser(n, 128, "maxpool", dev)}
    feats_cpu = feats.cpu()
    covered = torch.zeros(n, dtype=torch.bool)
    disagree = torch.zeros(n, dtype=torch.bool)
    differ = entries = 0
    card_s = 0.0
    for i, (pose, depth) in enumerate(zip(poses, depths)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ind_g = gpu_h.compute_projection(pts, torch.from_numpy(depth).to(dev), pose)
        if ind_g is not None:
            fused["gpu"].add(gpu_h.project(feats[i], *ind_g, n).T)
        torch.cuda.synchronize()
        card_s += time.perf_counter() - t0
        ind_c = cpu_h.compute_projection(points, depth, pose)
        if ind_c is not None:
            fused["cpu"].add(cpu_h.project(feats_cpu[i], *ind_c, n).T)
        a_g, a_c = _assignment(ind_g, n), _assignment(ind_c, n)
        diff = a_g != a_c
        differ += int(diff.sum())
        entries += int((a_c >= 0).sum())
        disagree |= diff
        covered |= a_g >= 0
    share = covered.float().mean().item()
    got, want = fused["gpu"].result().cpu(), fused["cpu"].result()
    same = torch.equal(got[~disagree], want[~disagree])
    log(f"[projection] {n} points, {MV_FRAMES} z-buffered 32x41 frames: {entries} "
        f"correspondences, {differ} differ card vs CPU (limit {INDEX_DIFF:g} of them); "
        f"{share:.1%} of the points covered; maxpool fusion equal on the "
        f"{int((~disagree).sum())} points whose correspondences agree: {same}; card "
        f"projection + fusion {card_s * 1e3 / MV_FRAMES:.2f} ms a frame (host clock)")
    if not differ <= INDEX_DIFF * entries or not share > MV_COVERAGE or not same:
        raise AssertionError("projection: card and CPU disagree, or the frames cover too little")
    return got.numpy()


def multiview_loader(root, spec, config, fused, batch_size=None):
    """The port's own loader over the fake root's train split with
    ``config`` on; ``_multiview_feats`` serves the first rows of the
    projection phase's fused features (the card's machine has no h5py)."""
    from instancerefer_tpu_torch.data import dataset as D

    class Served(D.ScannetReferenceDataset):
        def _multiview_feats(self, scene_id):
            return fused[:len(self._load_scene(scene_id)[0])]

    ds = Served(D.get_scanrefer(root, "train"), "train", data_root=root,
                num_points=SCENE_KW["num_points"], **{config: True})
    return D.PaddedLoader(ds, spec, batch_size or BATCH, shuffle=True, seed=0, num_workers=4)


def phase_multiview(dev, fused):
    """The ``use_multiview`` (Cin 135) train step and eval forward at
    B = BATCH from the port's dataset, the B = 2 f32 train parity at Cin 135,
    and one ``use_normal`` (Cin 10) train step; returns {config: (launches,
    stem launches)} of the train runs."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec

    root = tempfile.mkdtemp(prefix="mv_smoke_")
    out = {}
    try:
        write_fake_scanrefer(root, np.random.default_rng(1), CLI_BATCHES, BATCH)
        for config, n_batches in (("use_multiview", MV_BATCHES), ("use_normal", 1)):
            spec = BatchSpec(**SPEC_KW, feat_dim=MV_WIDTHS[config])
            it = iter(multiview_loader(root, spec, config, fused))
            batches, times = [], []
            for _ in range(n_batches):
                t0 = time.perf_counter()
                batches.append(next(it))
                times.append((time.perf_counter() - t0) * 1e3)
            it.close()
            feats = batches[0]["scene_feats"]
            log(f"[{config}] {n_batches} batches of {BATCH} from the port's dataset: scene "
                f"features {feats.shape}, batch build {times[0]:.1f} ms the first (loader "
                f"start included)" + (f", {np.mean(times[1:]):.1f} ms the next (mean of "
                                      f"{len(times) - 1})" if len(times) > 1 else ""))
            if feats.shape[-1] != MV_WIDTHS[config]:
                raise AssertionError(f"{config}: the stems take {feats.shape[-1]} channels")
            dds = [batch_to_torch(b, spec, dev) for b in batches]
            if config == "use_multiview":
                out[config] = phase_train(spec, dev, dds, label=config)
                phase_full(spec, dev, dds, make_model(spec, seed=2).to(dev), label=config)
                it = iter(multiview_loader(root, spec, config, fused, batch_size=2))
                pair = next(it)
                it.close()
                phase_train_parity(spec, dev, pair)
            else:
                out[config] = phase_train(spec, dev, dds, label=config, repeats=1, profile=False)
            del dds
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 10
DDP_WORLD = 2  # ranks of phase 10a, one process each, sharing the card over gloo
DDP_BF16_STEPS = 3
DDP_TIMEOUT = 300  # seconds the ranks of phase 10a may take
# phase 10b: one epoch of the train CLI on a fake root like phase 8's
DDP_CLI_BATCHES = {"train": 4, "val": 2}
# the profiler's names of a collective: the dispatcher's op and the
# backend's own event
COLLECTIVE = re.compile(r"^(c10d::|gloo:|nccl:)")


def ddp_cores():
    """The 32 scenes of phase 10a's global batch (the bench's scenes)."""
    from instancerefer_tpu_torch.data.synthetic import make_core_sample

    rng = np.random.default_rng(10)
    return [make_core_sample(rng, scan_idx=i, mean_size_arr=MEAN_SIZE, **SCENE_KW)
            for i in range(BATCH)]


class Scenes:
    """A dataset of ready ``CoreSample``s for ``PaddedLoader``."""

    static_scene_sampling = augment = False

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def get_core(self, idx, rng=None, class_override=None):
        return self.samples[idx]


def _step_state(metrics, model):
    """(loss, gradients, running statistics) of a step, on the CPU."""
    return (float(metrics["loss"]),
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()},
            {n: b.detach().cpu().clone() for n, b in model.named_buffers() if "running" in n})


def ddp_rank(rank: int, workdir: str) -> None:
    """Rank ``rank`` of phase 10a, in a process of its own.  Both ranks run
    on card 0 (``LOCAL_RANK`` 0), so they meet over gloo, through a
    ``file://`` store in ``workdir``; each loads its half of the 32 scenes
    (``host_shard_indices`` in its ``PaddedLoader``) and writes its results
    to ``workdir/rank<rank>.pt``."""
    from torch.profiler import ProfilerActivity, profile

    from instancerefer_tpu_torch.data.dataset import PaddedLoader
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.parallel import distributed
    from instancerefer_tpu_torch.train.solver import Solver, train_step

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK="0")
    dev = distributed.init_from_env("cuda", backend="gloo",
                                    init_method="file://" + os.path.join(workdir, "store"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(rank)  # the rank's dropout masks
    spec = BatchSpec(**SPEC_KW)
    out = {}
    try:
        loader = PaddedLoader(Scenes(ddp_cores()), spec, BATCH // DDP_WORLD, shuffle=False,
                              num_workers=4, process_index=rank, process_count=DDP_WORLD)
        dd = batch_to_torch(next(iter(loader)), spec, dev)
        out["valid"] = int(dd["sample_valid"].sum())

        def solver_for(seed, **kw):
            model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                                  generator=torch.Generator().manual_seed(seed), **kw)
            return Solver(model, MEAN_SIZE, spec, dev, lr=LR, wd=WD,
                          output_dir=os.path.join(workdir, "runs"))

        set_compute_dtype(None)  # one f32 step, as the single-process one
        torch.backends.cudnn.deterministic = True
        solver = solver_for(4, dropout_override=0.0)
        metrics, _ = train_step(solver.train_model, solver.optimizer, dd, solver.mean_size)
        out["wrapped"] = solver.train_model is not solver.model
        out["f32"] = _step_state(metrics, solver.model)
        torch.backends.cudnn.deterministic = False

        set_compute_dtype("bfloat16")  # the main path's steps
        solver = solver_for(5)
        counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                    "conv_dw": conv_bwd.conv_dw}

        def step():
            return train_step(solver.train_model, solver.optimizer, dd, solver.mean_size)

        step()  # warm-up
        for f in counters.values():
            f.launches = 0
        ms, losses = [], []
        for _ in range(DDP_BF16_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, res = step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            iou = res["ref_iou"]
            if not bool(((iou >= 0) & (iou <= 1)).all()):
                raise AssertionError(f"rank {rank}: ref_iou outside [0, 1]")
        out["launches"] = {k: f.launches for k, f in counters.items()}
        out["bf16"] = {"ms": ms, "loss": losses,
                       "finite": all(bool(torch.isfinite(p.grad).all())
                                     for p in solver.model.parameters()),
                       "params": {n: p.detach().cpu() for n, p in solver.model.named_parameters()}}
        # one more step, under the profiler on rank 0: the collectives
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            out["collectives"] = {
                ev.key: (ev.count, ev.cpu_time_total / 1e3, ev.device_time_total / 1e3)
                for ev in prof.key_averages() if COLLECTIVE.search(ev.key)}
        else:
            step()
    finally:
        set_compute_dtype(None)
        distributed.shutdown()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def phase_ddp(dev):
    """10a: two gloo ranks on the card against one process on the 32 scenes
    in the ranks' order (rank 0's half, then rank 1's)."""
    import multiprocessing

    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec, finalize_batch, pad_sample
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.parallel.distributed import host_shard_indices
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    spec = BatchSpec(**SPEC_KW)
    workdir = tempfile.mkdtemp(prefix="ddp_smoke_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ddp_rank, args=(r, workdir)) for r in range(DDP_WORLD)]
    try:
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        cores = ddp_cores()
        order = np.concatenate([host_shard_indices(BATCH, r, DDP_WORLD) for r in range(DDP_WORLD)])
        batch = finalize_batch([pad_sample(cores[i], spec) for i in order], BATCH, spec)
        set_compute_dtype(None)
        torch.backends.cudnn.deterministic = True
        model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                              generator=torch.Generator().manual_seed(4),
                              dropout_override=0.0).to(dev)
        metrics, _ = train_step(model, make_optimizer(model.parameters(), LR, WD),
                                batch_to_torch(batch, spec, dev),
                                torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev))
        single = _step_state(metrics, model)
        torch.backends.cudnn.deterministic = False
        del model, metrics
        for p in procs:
            p.join(max(DDP_TIMEOUT - (time.perf_counter() - t0), 1.0))
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 10a: the ranks ended with {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(DDP_WORLD)]
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)

    if not all(r["wrapped"] for r in ranks) or [r["valid"] for r in ranks] != [BATCH // DDP_WORLD] * DDP_WORLD:
        raise AssertionError("the ranks did not run DDP on half the batch each")
    log(f"[ddp] {DDP_WORLD} ranks on cuda:0 over gloo, {BATCH // DDP_WORLD} scenes each; one f32 "
        f"step (TF32 off, dropout 0) against one process on the {BATCH} scenes in the ranks' "
        "order:")
    check_step("ddp", ("one-process", "rank0"), single, ranks[0]["f32"])
    for k, per_step in TRAIN_LAUNCHES.items():
        for r, res in enumerate(ranks):
            if res["launches"][k] != per_step * DDP_BF16_STEPS:
                raise AssertionError(f"rank {r}: {k} {res['launches'][k]} launches in "
                                     f"{DDP_BF16_STEPS} steps, want {per_step} a step")
    same = all(torch.equal(p, ranks[1]["bf16"]["params"][n])
               for n, p in ranks[0]["bf16"]["params"].items())
    if not same or not all(r["bf16"]["finite"] and np.isfinite(r["bf16"]["loss"]).all()
                           for r in ranks):
        raise AssertionError("the ranks' parameters differ after the bf16 steps, or a loss or "
                             "gradient is not finite")
    log(f"[ddp] bf16: {DDP_BF16_STEPS} steps a rank, launches per step and rank " + ", ".join(
        f"{k} {ranks[0]['launches'][k] // DDP_BF16_STEPS}" for k in TRAIN_LAUNCHES)
        + f"; parameters bit-identical across the ranks after the last step: {same}; rank 0 "
        "losses " + ", ".join(f"{x:.4f}" for x in ranks[0]["bf16"]["loss"]))
    for r, res in enumerate(ranks):
        log(f"[ddp] rank {r} step ms: " + ", ".join(f"{t:.2f}" for t in res["bf16"]["ms"])
            + f" (host clock, synchronized; median {statistics.median(res['bf16']['ms']):.2f})")
    log("[ddp] one profiled bf16 step of rank 0, the collectives (the BatchNorms' statistics "
        "forward and backward, the loss and metric sums, DDP's gradient buckets) by profiler "
        "event: " + "; ".join(f"{key} x{n}: host {host:.2f} ms, device {device:.2f} ms"
                              for key, (n, host, device) in sorted(ranks[0]["collectives"].items()))
        + f"; phase 10a {wall:.1f} s wall")


def phase_ddp_cli(dev, dds):
    """10b: the train CLI at world size 1 over NCCL (``RANK=0 WORLD_SIZE=1``),
    then, in that group, one NCCL all-reduce and phase 7's train steps on
    ``dds`` (their launches and time beside phase 7's)."""
    import socket
    import warnings

    import torch.distributed as dist

    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.parallel import distributed
    from instancerefer_tpu_torch.scripts import train as train_cli

    counters = {"gather_conv": gather_conv, "subm_conv_bwd": conv_bwd.subm_conv_bwd,
                "conv_dw": conv_bwd.conv_dw}
    root = tempfile.mkdtemp(prefix="ddp_cli_smoke_")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        write_fake_scanrefer(root, np.random.default_rng(3), DDP_CLI_BATCHES, BATCH)
        with open(os.path.join(root, "main.yaml"), "w") as f:
            f.write(cli_config_text().replace("epoch: 2", "epoch: 1"))
        for f in counters.values():
            f.launches = 0
        out = io.StringIO()
        try:
            with warnings.catch_warnings(), contextlib.redirect_stdout(out):
                warnings.simplefilter("ignore")
                solver = train_cli.main([
                    "--config", os.path.join(root, "main.yaml"), "--log_dir", "ddp",
                    "--data_root", root, "--output_root", os.path.join(root, "outputs"),
                    "--device", "cuda"])
        except BaseException:
            log(out.getvalue()[-4000:])
            raise
        torch.cuda.synchronize()
        backend = dist.get_backend()
        n_train, n_val = solver.steps["train"], solver.steps["val"]
        got = {k: f.launches for k, f in counters.items()}
        want = {k: TRAIN_LAUNCHES[k] * n_train + EVAL_LAUNCHES[k] * n_val for k in counters}
        runs = os.listdir(os.path.join(root, "outputs", "ScanRefer", "ddp", "checkpoints"))
        run = os.path.join(root, "outputs", "ScanRefer", "ddp", "checkpoints", runs[0])
        finite = all(np.isfinite(r[k]) for r in _records(run) for k in ("loss", "ref_loss"))
        with open(os.path.join(run, "info.json")) as f:
            devices = json.load(f)["num_devices"]
        if (backend != "nccl" or distributed.world_size() != 1
                or solver.train_model is not solver.model or got != want
                or n_train != DDP_CLI_BATCHES["train"] or len(runs) != 1 or devices != 1
                or not finite):
            raise AssertionError(f"world-1 train CLI: backend {backend}, launches {got} (want "
                                 f"{want}), runs {runs}, num_devices {devices}, finite {finite}")
        for name in ("model_last.pth", "model.pth", "checkpoint.tar", "log.txt", "best.txt"):
            if not os.path.isfile(os.path.join(run, name)):
                raise AssertionError(f"the world-1 train CLI wrote no {name}")
        x = torch.arange(4.0, device=dev) + 1.0
        y = x.clone()
        dist.all_reduce(y)  # the one NCCL collective a single card can run
        torch.cuda.synchronize()
        if not torch.equal(x, y) or not torch.equal(distributed.all_reduce_sum(x), x):
            raise AssertionError("an all-reduce over one NCCL rank changed its input")
        log(f"[ddp] train CLI at world size 1 over {backend}: {n_train} train and {n_val} val "
            f"steps in {time.perf_counter() - t0:.1f} s, launches "
            + ", ".join(f"{k} {got[k]}" for k in counters)
            + f" (per train step {', '.join(f'{k} {v}' for k, v in TRAIN_LAUNCHES.items())}); "
            "no DDP wrapper, one run directory; all_reduce over the NCCL group returned its input")
        phase_train(BatchSpec(**SPEC_KW), dev, dds, label="train in a world-1 NCCL group",
                    profile=False)
    finally:
        distributed.shutdown()
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(root, ignore_errors=True)
        set_compute_dtype(None)


def phase_sanity(dev):
    """10c: the overfit check on the card."""
    from instancerefer_tpu_torch.scripts import sanity_train

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = sanity_train.run(60, 16, dev)
    log(f"[sanity] 60 bf16 steps at B=16 (largest-instance rule, chance ~0.33): ref_acc early "
        f"{res['early']:.3f} -> late {res['late']:.3f}, loss {res['loss'][0]:.3f} -> "
        f"{res['loss'][-1]:.3f}; {time.perf_counter() - t0:.1f} s")
    if not res["passed"]:
        log(out.getvalue()[-3000:])
        raise AssertionError("the overfit check failed on the card")


# ---------------------------------------------------------------- phase 11
PREP_SCANS = ("scene0000_00", "scene0001_00")
# a ScanNet _vh_clean_2 mesh's order of size, above the exporter's 50 000
PREP_VERTS, PREP_FACES, PREP_MASKS = 150000, 300000, 12
# card vs CPU export: the normals sum in float64 with atomics in another
# order (|diff| <= NORMAL_TOL); the aligned xyz and the boxes come from a
# float64 product in cuBLAS's order (1 float32 ulp); the rest is equal
NORMAL_TOL, COORD_ULP = 1e-6, 1
# the loss variants, card vs CPU: |diff| <= VARIANT_RTOL x max|cpu| of each
# value and input gradient (float32 sums in another order)
VARIANT_RTOL = 1e-5
VARIANT_CANDIDATES = (4, 32)  # the bench's candidates; > 20 negatives for ranking_loss


def _same_export(got_dir: str, want_dir: str) -> str:
    """The card's files against the CPU's, within the limits above; returns
    a summary of the differences."""
    from instancerefer_tpu_torch.data.prepare import ARTIFACTS

    worst = {"normal": 0.0, "ulp": 0}
    for scan in PREP_SCANS:
        for key in ARTIFACTS:
            got = np.load(os.path.join(got_dir, f"{scan}_{key}.npy"))
            want = np.load(os.path.join(want_dir, f"{scan}_{key}.npy"))
            if (got.dtype, got.shape) != (want.dtype, want.shape):
                raise AssertionError(f"{scan} {key}: {got.dtype} {got.shape} on the card, "
                                     f"{want.dtype} {want.shape} on the CPU")
            if key.endswith("vert"):
                normal = float(np.abs(got[:, 6:] - want[:, 6:]).max())
                exact, coords = got[:, 3:6], got[:, :3]
                want_exact, want_coords = want[:, 3:6], want[:, :3]
                worst["normal"] = max(worst["normal"], normal)
                if normal > NORMAL_TOL:
                    raise AssertionError(f"{scan} {key}: normals differ by {normal:.3e}")
            elif key.endswith("bbox"):
                exact, coords = got[:, 6:], got[:, :6].astype(np.float32)
                want_exact, want_coords = want[:, 6:], want[:, :6].astype(np.float32)
            else:
                exact, want_exact, coords = got, want, None
            if not np.array_equal(exact, want_exact):
                raise AssertionError(f"{scan} {key}: card and CPU files differ")
            if coords is not None:  # raises beyond COORD_ULP
                ulp = np.testing.assert_array_max_ulp(coords, want_coords, maxulp=COORD_ULP)
                worst["ulp"] = max(worst["ulp"], int(ulp.max()))
    return (f"normals within {worst['normal']:.3e} (limit {NORMAL_TOL:g}), coordinates and "
            f"boxes within {worst['ulp']} float32 ulp (limit {COORD_ULP}), labels, colors and "
            "ids equal")


def phase_prepare(dev) -> None:
    """11a-c and 11e: two raw scans exported on the card and on the CPU, the
    caps fitted to the prepared root, one train step and eval forward from
    it, and the visualize dumps."""
    from instancerefer_tpu_torch.config import load_config
    from instancerefer_tpu_torch.data import dataset as D
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.prepare import MAX_NUM_POINT, batch_export
    from instancerefer_tpu_torch.data.synthetic_scans import write_scannet_scans
    from instancerefer_tpu_torch.scripts import fit_caps, visualize
    from instancerefer_tpu_torch.scripts.eval import check_eval_overflow
    import warnings

    root = tempfile.mkdtemp(prefix="prep_smoke_")
    scannet = os.path.join(root, "scannet")
    try:
        # 11a
        t0 = time.perf_counter()
        boxes = write_scannet_scans(scannet, PREP_SCANS, np.random.default_rng(11),
                                    num_verts=PREP_VERTS, num_faces=PREP_FACES,
                                    num_masks=PREP_MASKS)
        log(f"[prepare] {len(PREP_SCANS)} raw scans of {PREP_VERTS} vertices and {PREP_FACES} "
            f"faces ({', '.join(f'{len(b)} boxes' for b in boxes.values())}, {PREP_MASKS} "
            f"PointGroup masks each) written in {time.perf_counter() - t0:.1f} s")

        # 11b
        dirs = {"cuda": os.path.join(scannet, "pointgroup_data"),
                "cpu": os.path.join(root, "pointgroup_data_cpu")}
        times = {}
        for side, device in (("cuda", dev), ("cpu", "cpu")):
            with contextlib.redirect_stdout(io.StringIO()):
                times[side] = batch_export("train", os.path.join(scannet, "scans"),
                                           os.path.join(scannet, "PointGroupInst"), dirs[side],
                                           os.path.join(scannet, "meta_data"), device=device)
        summary = _same_export(dirs["cuda"], dirs["cpu"])
        for scan in PREP_SCANS:
            log(f"[prepare] {scan} export ms (parse / device work / save): card " + " / ".join(
                f"{times['cuda'][scan][k]:.1f}" for k in ("parse", "device", "save"))
                + "; CPU " + " / ".join(f"{times['cpu'][scan][k]:.1f}"
                                        for k in ("parse", "device", "save")))
        log(f"[prepare] card vs CPU export: 8 files a scan, {summary}")

        # 11c
        rng = np.random.default_rng(12)
        kept = {scan: np.load(os.path.join(dirs["cuda"], f"{scan}_aligned_bbox.npy"))[:, 7]
                for scan in PREP_SCANS}
        names = {scan: dict(objs) for scan, objs in boxes.items()}
        anns, seen = [], {}
        for _ in range(BATCH):
            scan = PREP_SCANS[int(rng.integers(len(PREP_SCANS)))]
            obj = int(rng.choice(kept[scan]))
            ann_id = seen[scan, obj] = seen.get((scan, obj), -1) + 1
            anns.append(description(rng, scan, obj, names[scan][obj], ann_id))
        for split in ("train", "val"):
            with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
                json.dump(anns, f)
        write_glove(root, rng)
        profile = os.path.join(root, "caps.yaml")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            fitted = fit_caps.main(["--config", os.path.join(REPO, "config", "InstanceRefer.yaml"),
                                    "--data_root", root, "--split", "val", "--batches", "4",
                                    "--batch_size", str(BATCH // 4), "--fit-caps",
                                    "--emit-yaml", profile])
        log(f"[prepare] caps fitted to the prepared root's {BATCH} descriptions in "
            f"{time.perf_counter() - t0:.1f} s: {fitted}")
        with open(os.path.join(root, "prepared.yaml"), "w") as f:
            f.write(cli_config_text(profile))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the profile overrides the yaml's caps, on purpose
            cfg = load_config(["--config", os.path.join(root, "prepared.yaml"), "--data_root", root])
        spec = cfg.batch_spec()
        dds = {}
        for split in ("train", "val"):
            t0 = time.perf_counter()
            ds = D.ScannetReferenceDataset(D.get_scanrefer(root, split), split, data_root=root,
                                           num_points=cfg.num_points, use_augment=cfg.use_augment)
            it = iter(D.PaddedLoader(ds, spec, BATCH, shuffle=split == "train", seed=0,
                                     num_workers=4))
            batch = next(it)
            it.close()
            ov = {k: float(np.asarray(batch[f"{k}_overflow"]).max()) for k in ("scene", "inst", "cand")}
            log(f"[prepare] {split} batch of {BATCH} from the prepared scans in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms; largest overflow {ov}")
            if split == "val":
                check_eval_overflow(ov, allow=False)  # the eval CLI's gate
            dds[split] = batch_to_torch(batch, spec, dev)
        phase_train(spec, dev, [dds["train"]], label="prepared", repeats=1)
        phase_full(spec, dev, [dds["val"]], make_model(spec, seed=2).to(dev), label="prepared eval")

        # 11e
        out = os.path.join(root, "viz")
        with contextlib.redirect_stdout(io.StringIO()):
            written = visualize.main(["--scene", PREP_SCANS[0], "--data", dirs["cuda"], "--out", out,
                                      "--boxes"])
        n_boxes = len(kept[PREP_SCANS[0]])
        counts = []
        for path in written:
            with open(path) as f:
                counts.append(sum(line.startswith("v ") for line in f))
        n_verts = min(PREP_VERTS, MAX_NUM_POINT)
        want = [n_verts, n_verts, 8 * n_boxes]
        log(f"[prepare] visualize --boxes: {[os.path.basename(p) for p in written]} with "
            f"{counts} vertices")
        if counts != want:
            raise AssertionError(f"visualize wrote {counts} vertices, want {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def loss_variant_cases(rng: np.random.Generator, c: int):
    """name -> (port function, numpy arguments, indices of the
    differentiated ones) at B = BATCH and ``c`` candidates, with padded
    slots and rows without a positive."""
    from instancerefer_tpu_torch.train import losses as L

    b = BATCH
    sim = rng.uniform(-1, 1, size=(b, c)).astype(np.float32)
    label = np.zeros((b, c), np.float32)
    label[np.arange(b), rng.integers(0, c, size=b)] = 1.0
    label[::5] = 0.0
    mask = rng.random((b, c)) < 0.8
    mask[np.arange(b), label.argmax(1)] = True
    mask[:, 0] = True
    preds = (3 * rng.normal(size=b * c)).astype(np.float32)
    seg_labels = (rng.random(b * c) < 0.3).astype(np.float32)
    box = [(1.5 * rng.normal(size=(b, 3))).astype(np.float32) for _ in range(4)]
    box_mask = (rng.random(b) < 0.7).astype(np.float32)
    seg_scores = rng.normal(size=(b, 9)).astype(np.float32)
    center = rng.uniform(0, 4, size=(b, 3)).astype(np.float32)
    lang = rng.normal(size=(b, 18)).astype(np.float32)
    cat = rng.integers(0, 18, size=b)
    valid = rng.random(b) < 0.8
    lo, hi = np.zeros((b, 3), np.float32), np.full((b, 3), 4.0, np.float32)

    def scene_mask(scores, ctr, vld):
        return L.compute_scene_mask_loss({"seg_scores": scores, "ref_center_label": ctr,
                                          "point_min": ctr.new_tensor(lo),
                                          "point_max": ctr.new_tensor(hi)}, vld)

    return {
        "softmax_ranking_loss": (L.softmax_ranking_loss, (sim, label, mask), (0,)),
        "simclr_loss": (L.simclr_loss, (sim, label, mask), (0,)),
        "ranking_loss": (L.ranking_loss, (sim, label, mask), (0,)),
        "seg_focal_loss": (L.seg_focal_loss, (preds, seg_labels, rng.random(b * c) < 0.8), (0,)),
        "compute_box_loss": (L.compute_box_loss, (*box, box_mask), (0, 1)),
        "cross_entropy": (L.cross_entropy, (lang, cat), (0,)),
        "compute_scene_mask_loss": (scene_mask, (seg_scores, center, valid), (0,)),
        "compute_lang_classification_loss": (
            lambda x, y, v: L.compute_lang_classification_loss({"lang_scores": x, "object_cat": y}, v),
            (lang, cat, valid), (0,)),
    }


def phase_loss_variants(dev) -> None:
    """11d: the loss variants and the named loss pieces, card vs CPU: each
    value and input gradient (autograd of the sum of the float outputs)."""
    worst = 0.0
    for c in VARIANT_CANDIDATES:
        for name, (fn, args, diff) in loss_variant_cases(np.random.default_rng(13 + c), c).items():
            sides = {}
            for side in ("cpu", dev):
                xs = [torch.from_numpy(np.asarray(a)).to(side) for a in args]
                for i in diff:
                    xs[i].requires_grad_(True)
                out = fn(*xs)
                outs = out if isinstance(out, tuple) else (out,)
                total = sum((k + 1) * o.sum() for k, o in enumerate(outs) if o.is_floating_point())
                grads = torch.autograd.grad(total, [xs[i] for i in diff])
                sides[str(side)] = [o.detach().cpu() for o in (*outs, *grads)]
            for k, (g, w) in enumerate(zip(sides[str(dev)], sides["cpu"])):
                if w.is_floating_point():
                    err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    ok = bool(torch.isfinite(w).all()) and err <= VARIANT_RTOL
                else:  # the region labels
                    err, ok = 0.0, torch.equal(g, w)
                if not ok:
                    raise AssertionError(f"{name} at C={c}, output {k}: card and CPU differ "
                                         f"({err:.3e} of the largest)")
                worst = max(worst, err)
    log(f"[loss-variants] {len(loss_variant_cases(np.random.default_rng(0), 4))} functions at B="
        f"{BATCH}, C={VARIANT_CANDIDATES}: values and input gradients card vs CPU within "
        f"{worst:.3e} of the largest (limit {VARIANT_RTOL:g})")


# ---------------------------------------------------------------- phase 12
GRAPH_RUNS = 2  # rounds of eager, graph, graph, eager in the timing of 12d
GRAPH_STEPS = 5  # steps a timed run
SHAPE_REPLAYS = 10  # replays of each step under the profiler in 12e
# a wrapper's launch as the profiler names its kernels: the first kernel of
# each launch (K1, and the down convs' dX over the lists; K2's dX; K3; "L",
# the list pass a down's backward runs before both), then the kernels that
# finish it (K2's dW; the list pass's writes; the sum of the splits)
LAUNCH_FIRST = {
    "K1": re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel"
                     r"|dx_list_tc_kernel"),
    "K2": re.compile(r"gather_gemm(_tc)?_kernel<.*true>"),
    "K3": re.compile(r"dw_partial_kernel<.*true>|stem_wide_dw_kernel|dw_list_tc_kernel"),
    "L": re.compile(r"dw_list_count_kernel"),
}
LAUNCH_REST = re.compile(r"dw_partial_kernel<.*false>|dw_group_tc_kernel|sum_partials_kernel"
                         r"|dw_list_write_kernel")


@contextlib.contextmanager
def record_launches():
    """The sparse-conv wrappers' calls made inside, in order, as dicts
    (kernel, route, V_out, K, Cin, Cout, the output, the map, the bytes the
    function must move and those it writes a valid map entry, and where
    the plan is not ``plan_text``'s, its text): the names the model's
    modules call the wrappers by are wrapped, and restored after.  A
    down's backward records the list pass ("L"), then its dX (K1: rows and
    widths as K1 over ``up8`` with W^T), then K3."""
    from instancerefer_tpu_torch.models import basic_blocks
    from instancerefer_tpu_torch.ops import sparse_conv
    from instancerefer_tpu_torch.ops.conv_bwd import dx_list_splits
    from instancerefer_tpu_torch.ops.gather_conv import route, sm_count

    calls = []

    def describe(kernel, args, kw):
        if kernel == "L":
            nbr = args[0]
            return {"kernel": "L", "route": "twin" if nbr.device.type == "cpu" else "tensor_core",
                    "v_out": nbr.shape[0], "k": nbr.shape[1], "cin": 0, "cout": 0,
                    "what": "list pass", "nbr": nbr, "bytes": nbytes(nbr) + 4 * nbr.shape[1],
                    "valid_bytes": 4, "mults": 0, "dtype": torch.bfloat16, "plan": ""}
        if kernel == "K1 dX":  # down_dx(g, down, up8, weight, lists)
            g, nbr, up8, w = args[:4]
            k, cin, cout = w.shape
            path = route(g.dtype, cin, g.device)
            plan = ""
            if path == "tensor_core":
                splits = dx_list_splits(nbr.shape[0], k, cin, cout, sm_count(g.device))
                plan = f" plan per-offset lists, {splits} blocks a list"
            return {"kernel": "K1", "route": path, "v_out": up8.shape[0], "k": k, "cin": cout,
                    "cout": cin, "what": "dX over the lists", "nbr": nbr,
                    "bytes": nbytes(g, up8, w) + up8.shape[0] * cin * 4, "mults": 2,
                    "dtype": g.dtype, "plan": plan}
        feats, nbr = args[0], args[1]
        if kernel == "K1":
            w = args[2]
            (k, cin, cout), out = w.shape, kw.get("out_dtype") or feats.dtype
            epi = len(args) > 3 and args[3] is not None
            what = "f32 out" if out == torch.float32 and feats.dtype != out else \
                ("epilogue" if epi else "no epilogue")
            nb = feats.shape[0] * cin * feats.element_size() + nbytes(nbr, w) \
                + nbr.shape[0] * cout * torch.finfo(out).bits // 8 + (2 * cout * 4 if epi else 0)
            mults = 2
        elif kernel == "K2":
            g, w = args[2], args[3]
            k, cin, cout = w.shape
            what, mults = "dX and dW", 4
            nb = nbytes(feats, nbr, g, w) + feats.shape[0] * cin * 4 + w.numel() * 4
        else:
            g = args[2]
            k, cin, cout = nbr.shape[1], kw.get("cin") or feats.shape[1], g.shape[1]
            what, mults = "dW", 2
            nb = feats.shape[0] * cin * feats.element_size() + nbytes(nbr, g) + k * cin * cout * 4
        return {"kernel": kernel, "route": route(feats.dtype, cin, feats.device),
                "v_out": nbr.shape[0], "k": k, "cin": cin, "cout": cout, "what": what,
                "nbr": nbr, "bytes": nb, "mults": mults, "dtype": feats.dtype}

    patched = []
    for module, name, kernel in ((basic_blocks, "gather_conv", "K1"),
                                 (sparse_conv, "gather_conv", "K1"),
                                 (sparse_conv, "down_lists", "L"),
                                 (sparse_conv, "down_dx", "K1 dX"),
                                 (sparse_conv, "subm_conv_bwd", "K2"),
                                 (sparse_conv, "conv_dw", "K3")):
        real = getattr(module, name)

        def call(*args, _real=real, _kernel=kernel, **kw):
            calls.append(describe(_kernel, args, kw))
            return _real(*args, **kw)

        setattr(module, name, call)
        patched.append((module, name, real))
    try:
        yield calls
    finally:
        for module, name, real in patched:
            setattr(module, name, real)


def launch_groups(prof):
    """The profiler's sparse-conv kernels, in the order they ran, grouped
    by launch: [(kernel, device ms)]."""
    from torch.autograd import DeviceType

    events = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                    key=lambda ev: ev.time_range.start)
    groups = []
    for ev in events:
        first = next((k for k, pat in LAUNCH_FIRST.items() if pat.search(ev.name)), None)
        ms = ev.time_range.elapsed_us() / 1e3
        if first is not None:
            groups.append([first, ms])
        elif LAUNCH_REST.search(ev.name):
            if not groups:
                raise AssertionError(f"the profiler shows {ev.name} before any launch")
            groups[-1][1] += ms
    return groups


def shape_table(label, graphs_steps, replays=SHAPE_REPLAYS):
    """Per launch of each captured step (``graphs_steps``: [(name, launches
    recorded at its capture, replay function)]), the device's own ms from
    the profiler over ``replays`` replays, merged by shape: one ``[shape]``
    line per (kernel, shape, map) with its launches in each step, the
    device's ms a launch in each (the mean over its launches and replays)
    and its bound.  K1's forward is one shape in both steps (no epilogue in
    the train step, the folded BN and ReLU in the eval step)."""
    from torch.profiler import ProfilerActivity

    rows = {}
    for name, calls, replay in graphs_steps:
        replay()
        found = {}

        def replays_run(replay=replay):
            for _ in range(replays):
                replay()

        def disagreement(prof, calls=calls):
            found["groups"] = launch_groups(prof)
            if [g[0] for g in found["groups"]] == [c["kernel"] for c in calls] * replays:
                return None
            return (f"the profiler's {len(found['groups'])} launches do not follow the "
                    f"{len(calls)} captured ones {replays} times")

        profile_until(f"{label} {name}", replays_run, [ProfilerActivity.CUDA], disagreement)
        groups = found["groups"]
        for i, c in enumerate(calls):
            nnz = int((c["nbr"] >= 0).sum())
            what = "forward" if c["what"] in ("epilogue", "no epilogue") else c["what"]
            key = (c["kernel"], what, c["v_out"], c["k"], c["cin"], c["cout"], nnz, c["route"])
            row = rows.setdefault(key, {"launches": {}, "ms": {}, "call": c})
            row["launches"][name] = row["launches"].get(name, 0) + 1
            row["ms"].setdefault(name, []).extend(
                groups[r * len(calls) + i][1] for r in range(replays))
    names = [n for n, _, _ in graphs_steps]
    totals = {n: 0.0 for n in names}
    for key, row in sorted(rows.items(), key=lambda kv: (kv[0][0], kv[0][1], -kv[0][2], kv[0][6])):
        kernel, what, v_out, k, cin, cout, nnz, path = key
        c = row["call"]
        flops, nb = c["mults"] * nnz * cin * cout, c["bytes"] + nnz * c.get("valid_bytes", 0)
        b_ms, b_by = bound(flops, nb, c["dtype"])
        ms = {n: statistics.mean(t) for n, t in row["ms"].items()}
        for n, t in ms.items():
            totals[n] += t * row["launches"][n]
        out_dtype = torch.float32 if c["what"] == "f32 out" else c["dtype"]
        plan = c.get("plan")
        if plan is None:
            plan = plan_text(kernel, path, v_out, k, cin, cout, out_dtype, c["nbr"].device)
        log(f"[shape] {label} {kernel} {what} V_out={v_out} K={k} {cin}->{cout} "
            f"valid={nnz} route={path}{plan}: launches "
            + " / ".join(
                f"{row['launches'].get(n, 0)} {n}" for n in names)
            + "; device ms a launch under graph replays " + " / ".join(
                f"{ms[n]:.4f} {n}" for n in names if n in ms)
            + f"; bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nb / 1e6:.1f} MB)")
    log(f"[shape] {label}: sparse-conv device ms a step under graph replays: " + ", ".join(
        f"{n} {t:.3f}" for n, t in totals.items()) + f" ({len(rows)} shapes)")


def _with_grid(batch, grid):
    """A host batch cut to the language grid ``grid`` (lengths clamped)."""
    out = dict(batch)
    out["lang_feat"] = np.ascontiguousarray(batch["lang_feat"][:, :grid])
    out["lang_len"] = np.minimum(batch["lang_len"], grid)
    return out


def _steps_launches(before, after, n_steps, per_step, label):
    got = {k: after[k] - before[k] for k in per_step}
    if got != {k: v * n_steps for k, v in per_step.items()}:
        raise AssertionError(f"{label}: launches {got} in {n_steps} steps, want "
                             f"{per_step} a step")
    return got


def _graph_model(spec, dev, seed, **kw):
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer

    return InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                         generator=torch.Generator().manual_seed(seed), **kw).to(dev)


def _launch_counts():
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops.gather_conv import gather_conv

    return {"gather_conv": gather_conv.launches, "subm_conv_bwd": conv_bwd.subm_conv_bwd.launches,
            "conv_dw": conv_bwd.conv_dw.launches}


@torch.no_grad()
def copy_train_state(src_model, src_opt, dst_model, dst_opt):
    """``dst`` takes ``src``'s parameters, buffers and Adam state in place
    (the tensors a captured step reads)."""
    for d, s in zip(dst_model.state_dict().values(), src_model.state_dict().values()):
        d.copy_(s)
    for dp, sp in zip(dst_model.parameters(), src_model.parameters()):
        for k, v in src_opt.state[sp].items():
            dst_opt.state[dp][k].copy_(v)


def _param_drift(ref_model, model, steps):
    """Mean |diff| of all parameters in lr, after ``steps`` Adam steps from
    one state; raises if an element lies beyond 2.5 x the summed lr +
    1e-3 |p|."""
    ref = {n: p.detach().cpu() for n, p in ref_model.named_parameters()}
    total, count = 0.0, 0
    for n, p in model.named_parameters():
        diff = (p.detach().cpu() - ref[n]).abs()
        if not bool((diff <= 2.5 * steps * LR + 1e-3 * ref[n].abs()).all()):
            raise AssertionError(f"{n} after {steps} Adam steps: max |diff| "
                                 f"{diff.max().item():.3e}")
        total += diff.sum().item()
        count += diff.numel()
    return total / count / LR


def _eval_diff(got, want):
    """The largest |got - want| over the eval step's scores and loss;
    raises beyond phase 3's limits."""
    worst = 0.0
    for key in ("loss", "lang_scores", "attribute_scores", "relation_scores", "scene_scores",
                "seg_scores"):
        a, b = got[key].cpu(), want[key].cpu()
        err = (a - b).abs()
        worst = max(worst, err.max().item())
        if not bool((err <= SLICE_ATOL + SLICE_RTOL * b.abs()).all()):
            raise AssertionError(f"eval steps disagree on {key}")
    return worst


def graphs_parity(spec, dev, ms):
    """12a: f32, TF32 off, deterministic cuDNN, dropout 0, two 2-scene
    batches of one language grid (A and B: other scenes, other description
    lengths), the same weights on three models: an eager one, its eager
    twin and a graphed one.  Each takes one step on A (the graphed one's
    warm-up and capture), the eager model's state is copied into the other
    two, then each steps on B and on A: the graph replays B (written into
    the inputs captured from A) against the eager step on B, held as phase
    6 holds the card against the CPU, beside the twin's eager step on B
    against it (eager against eager on the card: the floor that the BEV
    scatter's atomics leave).  The parameters after the 2 steps likewise.
    Then the eval graph captured on A and replayed on B against the eager
    eval step on B (phase 3's limits), beside that eager eval step run
    twice.  Returns the losses of two replays at lr 0 (dropout 0: the same
    loss twice)."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step
    from instancerefer_tpu_torch.train.step_graph import StepGraphs, eval_body

    set_compute_dtype(None)
    torch.backends.cudnn.deterministic = True
    host = [make_batch(2, spec, seed=s, mean_size_arr=MEAN_SIZE, **SCENE_KW) for s in (3, 9)]
    if host[0]["lang_feat"].shape != host[1]["lang_feat"].shape \
            or np.array_equal(host[0]["lang_len"], host[1]["lang_len"]):
        raise AssertionError("12a wants two batches of one grid with other lengths")
    d_a, d_b = (batch_to_torch(b, spec, dev) for b in host)
    eager, twin, graphed = (_graph_model(spec, dev, 4, dropout_override=0.0) for _ in range(3))
    opts = [make_optimizer(m.parameters(), LR, WD) for m in (eager, twin, graphed)]
    graphs = StepGraphs(graphed, opts[2], ms)
    train_step(eager, opts[0], d_a, ms)
    train_step(twin, opts[1], d_a, ms)
    graphs.train_step(d_a)  # the warm-up, then the capture on A
    copy_train_state(eager, opts[0], twin, opts[1])
    copy_train_state(eager, opts[0], graphed, opts[2])
    states = []
    for dd in (d_b, d_a):
        e_metrics, _ = train_step(eager, opts[0], dd, ms)
        t_metrics, _ = train_step(twin, opts[1], dd, ms)
        g_metrics, _ = graphs.train_step(dd)
        if not states:
            states = [_step_state(m, model) for m, model in
                      ((e_metrics, eager), (t_metrics, twin), (g_metrics, graphed))]
    torch.cuda.synchronize()
    if graphs.captures != 1:
        raise AssertionError(f"12a: {graphs.captures} captures of one key")
    log(f"[graph] 12a f32 B=2, lengths A {host[0]['lang_len'].tolist()} B "
        f"{host[1]['lang_len'].tolist()}, from one state; the floor, eager against eager on B:")
    check_step("graph", ("eager", "eager again"), states[0], states[1])
    log("[graph] 12a the graph captured on A, its replay on B against the eager step on B:")
    check_step("graph", ("eager", "graph"), *states[::2])
    floor, drift = _param_drift(eager, twin, 2), _param_drift(eager, graphed, 2)
    if not drift <= ADAM_MEAN:
        raise AssertionError("graph and eager parameters drift apart")

    graphed.eval()  # the eval graph, captured on A, replayed on B
    graphs.eval_step(d_a)
    want = eval_body(graphed, d_b, ms)[1]
    again = eval_body(graphed, d_b, ms)[1]
    got = graphs.eval_step(d_b)[1]
    e_floor, e_diff = _eval_diff(again, want), _eval_diff(got, want)
    log(f"[graph] 12a parameters after 2 Adam steps (B, then A): mean |diff| against the "
        f"eager model's {drift:.4f} lr replayed, {floor:.4f} lr eager again (limit "
        f"{ADAM_MEAN:g}); the eval graph captured on A, replayed on B, against the eager eval "
        f"step on B: max |diff| {e_diff:.3e}, eager again {e_floor:.3e} (atol {SLICE_ATOL:g} + "
        f"rtol {SLICE_RTOL:g})")
    # a replay at lr 0 keeps the weights, so with dropout 0 the loss repeats
    opts[2].param_groups[0]["lr"].fill_(0.0)
    control = [float(graphs.train_step(d_a)[0]["loss"]) for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    return control


def graphs_keys(spec, dev, batches, control):
    """12b: bf16 at B = BATCH through the solver: two language grids (two
    keys), a checkpoint load that drops the graphs, the recaptures, the
    launches a step.  12c: dropout on (the model's own rates) at lr 0, two
    replays of one batch draw different masks, so their losses differ
    (``control``: the same with dropout 0)."""
    from instancerefer_tpu_torch.data.host import stage_to
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import Solver

    set_compute_dtype("bfloat16")
    grids = [batches[0]["lang_feat"].shape[1], 64]
    host = [batches[0], _with_grid(batches[1], grids[1]), batches[2],
            _with_grid(batches[0], grids[1])]
    workdir = tempfile.mkdtemp(prefix="graph_smoke_")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            solver = Solver(_graph_model(spec, dev, 5), MEAN_SIZE, spec, dev, lr=LR, wd=WD,
                            output_dir=workdir)
        graphs = solver.graphs
        if graphs is None:
            raise AssertionError("the solver on one card does not step through graphs")

        def load(batch):
            return graphs.load(stage_to(batch, spec, dev), spec, "train")

        before = _launch_counts()
        losses = []
        for batch in host + host[:1]:
            losses.append(float(graphs.train_step(load(batch))[0]["loss"]))
        keys = sorted(graphs.graphs)
        with contextlib.redirect_stdout(io.StringIO()):
            solver.load_checkpoint(solver.save_checkpoint("checkpoint", with_opt=True),
                                   with_opt=True)
        dropped = len(graphs.graphs)
        for batch in host[:2] * 2:
            losses.append(float(graphs.train_step(load(batch))[0]["loss"]))
        n_steps = len(host) + 1 + 4
        got = _steps_launches(before, _launch_counts(), n_steps, TRAIN_LAUNCHES, "12b")
        if keys != [("train", g, "torch.bfloat16") for g in sorted(grids)] or dropped \
                or graphs.captures != 4 or not np.isfinite(losses).all():
            raise AssertionError(f"12b: keys {keys}, {dropped} graphs after the load, "
                                 f"{graphs.captures} captures, losses {losses}")
        log(f"[graph] 12b bf16 B={BATCH}: language grids {grids} (keys {keys}); a checkpoint "
            f"load dropped every graph, {graphs.captures} captures in all; {n_steps} steps, "
            "launches per step " + ", ".join(f"{k} {v // n_steps}" for k, v in got.items())
            + "; losses " + ", ".join(f"{x:.4f}" for x in losses))

        solver.optimizer.param_groups[0]["lr"].fill_(0.0)
        static = load(host[0])
        drawn = [float(graphs.train_step(static)[0]["loss"]) for _ in range(2)]
        log(f"[graph] 12c two replays of one batch at lr 0: dropout on, losses {drawn[0]:.6f} "
            f"and {drawn[1]:.6f}; dropout 0 (12a, f32), {control[0]:.6f} and {control[1]:.6f}")
        if drawn[0] == drawn[1] or abs(control[0] - control[1]) > 1e-5 * abs(control[0]):
            raise AssertionError("12c: replays do not draw new dropout masks, or a replay with "
                                 "dropout 0 does not repeat its loss")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def graphs_timing(spec, dev, ms, dd):
    """12d: eager and graph side by side at B = BATCH, bf16, the same
    weights and batch: each path's peak memory over its first train and
    eval steps (the graphs' warm-ups and captures included), then scenes/s
    in runs of GRAPH_STEPS steps, alternated eager, graph, graph, eager;
    then a graph train and eval step under the profiler."""
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step
    from instancerefer_tpu_torch.train.step_graph import StepGraphs, eval_body

    paths = {}
    for name in ("eager", "graph"):
        model = _graph_model(spec, dev, 6)
        opt = make_optimizer(model.parameters(), LR, WD)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        if name == "eager":
            def train(model=model, opt=opt):
                return train_step(model, opt, dd, ms)

            def evaluate(model=model):
                model.eval()
                return eval_body(model, dd, ms)
        else:
            g = StepGraphs(model, opt, ms)
            g.train_step(dd)
            g.eval_step(dd)
            t_in, e_in = static_inputs(g, "train", dd), static_inputs(g, "eval", dd)

            def train(g=g, t_in=t_in):
                return g.train_step(t_in)

            def evaluate(g=g, e_in=e_in):
                return g.eval_step(e_in)
        train()
        evaluate()
        torch.cuda.synchronize()
        paths[name] = {"train": train, "eval": evaluate, "ms": {"train": [], "eval": []},
                       "peak": torch.cuda.max_memory_allocated(dev),
                       "reserved": torch.cuda.memory_reserved(dev)}
    for _ in range(GRAPH_RUNS):
        for name in ("eager", "graph", "graph", "eager"):
            for kind in ("train", "eval"):
                fn = paths[name][kind]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(GRAPH_STEPS):
                    metrics, _ = fn()
                float(metrics["loss"])
                torch.cuda.synchronize()
                paths[name]["ms"][kind].append((time.perf_counter() - t0) / GRAPH_STEPS * 1e3)
    for name, p in paths.items():
        log(f"[graph] 12d {name} B={BATCH} bf16: " + "; ".join(
            f"{kind} {BATCH / statistics.median(t) * 1e3:.2f} scenes/s (ms a step, runs of "
            f"{GRAPH_STEPS}: " + ", ".join(f"{x:.2f}" for x in t) + ")"
            for kind, t in p["ms"].items())
            + f"; peak device memory {p['peak'] / 2**20:.1f} MiB over its first train and eval "
              f"steps, {p['reserved'] / 2**20:.1f} MiB reserved after them")
    for kind in ("train", "eval"):
        e, g = (statistics.median(paths[n]["ms"][kind]) for n in ("eager", "graph"))
        log(f"[graph] 12d {kind} step: graph {g:.2f} ms, eager {e:.2f} ms ({e / g:.2f}x)")
    for kind in ("train", "eval"):
        profile_kernels(f"graph {kind} step B={BATCH} Cin={spec.feat_dim} bf16 (12d)",
                        paths["graph"][kind])
        profile_kernels(f"eager {kind} step B={BATCH} Cin={spec.feat_dim} bf16 (12d)",
                        paths["eager"][kind])


def graphs_shapes(spec, dev, ms, dd):
    """12e: every launch of the main path by shape, the device's own ms a
    launch under graph replays beside its bound (``shape_table``); 12f: the
    train and eval step bodies, eagerly, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from instancerefer_tpu_torch.train.solver import make_optimizer
    from instancerefer_tpu_torch.train.step_graph import StepGraphs, eval_body, train_body

    model = _graph_model(spec, dev, 7)
    g = StepGraphs(model, make_optimizer(model.parameters(), LR, WD), ms)
    steps = []
    for kind, step in (("train", g.train_step), ("eval", g.eval_step)):
        with record_launches() as calls:
            step(dd)  # the warm-up, then the capture: the same launches twice
        half = len(calls) // 2
        if [c["kernel"] for c in calls[:half]] != [c["kernel"] for c in calls[half:]]:
            raise AssertionError(f"12e {kind}: the capture launched otherwise than the warm-up")
        kernels = [c["kernel"] for c in calls[half:]]
        per_step = {"train": TRAIN_LAUNCHES, "eval": EVAL_LAUNCHES}[kind]
        want = {k: n for k, n in zip(("K1", "K2", "K3"), per_step.values()) if n}
        if kind == "train":
            want["L"] = LIST_LAUNCHES  # the list pass of each down's backward
        if {k: kernels.count(k) for k in set(kernels)} != want:
            raise AssertionError(f"12e {kind}: {len(kernels)} launches recorded, want {want}")
        inputs = static_inputs(g, kind, dd)
        steps.append((kind, calls[half:], lambda step=step, inputs=inputs: step(inputs)))
    shape_table(f"B={BATCH} Cin={spec.feat_dim} bf16", steps)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.train()
        train_body(model, g.optimizer, dd, ms)
        model.eval()
        eval_body(model, dd, ms)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[graph] 12f the train and eval step bodies ran eagerly under "
        "torch.cuda.set_sync_debug_mode('error'): no synchronizing call")


def phase_graphs(spec, dev, batches):
    """12: the steps' CUDA graphs beside the eager steps on the card."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    try:
        control = graphs_parity(spec, dev, ms)
        graphs_keys(spec, dev, batches, control)
        dd = batch_to_torch(batches[0], spec, dev)
        graphs_timing(spec, dev, ms, dd)
        graphs_shapes(spec, dev, ms, dd)
    finally:
        set_compute_dtype(None)


# ---------------------------------------------------------------- phase 13
BENCH_ITERS = 5  # timed replays of each bench run in 13a
BENCH_FED_ITERS = 10  # fed iterations of each bench run in 13a
BENCH_TIMEOUT = 600  # seconds a bench run may take
DRIFT_STEPS = 3  # 13b: steps on one batch
DRIFT_SEEDS = 5  # 13b: runs, each of its own weights and batch
# 13b, from one state: at each later step the graph's largest reading over
# the runs (loss, gradients overall and per layer) stays within phase 6's
# limit or DRIFT_K x the floor's largest (eager against eager, the same
# runs).  With the atomics' noise taken away both should read 0; a fault
# that reads stale inputs or a value baked in at the capture reads O(1)
DRIFT_K = 4.0


def phase_bench():
    """13a: the port's bench (``scripts/bench.py``) at B = BATCH, eval then
    train, each in a process of its own, as a user runs it: its JSON says
    the card, the correctness gate true (the first replay against an eager
    step of a copy from one state, the kernels of that step against their
    plain twins, finite outputs, no overflow) and the launches a step of
    the timed replays and of the fed run (34 / 16 / 10 and 26)."""
    import sys

    from instancerefer_tpu_torch.scripts import bench

    torch.cuda.empty_cache()
    for mode in ("eval", "train"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "instancerefer_tpu_torch.scripts.bench", "--mode", mode,
             "--batch", str(BATCH), "--iters", str(BENCH_ITERS), "--fed-iters",
             str(BENCH_FED_ITERS)],
            cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            log(proc.stdout[-2000:] + proc.stderr[-4000:])
            raise AssertionError(f"13a: the {mode} bench failed (rc {proc.returncode})")
        r = json.loads(lines[-1])
        checks = r["checks"]
        want = dict(zip(bench.COUNTER_NAMES, bench.LAUNCHES[mode]))
        if r["device"]["platform"] != "gpu" or not r["correct"] \
                or not checks["replay_vs_eager"]["ok"] or not checks["kernels_vs_twins_ok"] \
                or checks["launches_per_step"] != want or checks["fed_launches_per_step"] != want:
            raise AssertionError(f"13a: the {mode} bench's result: {r['device']}, correct "
                                 f"{r['correct']}, {checks}")
        prof, fed, agree = r["profile"], r["fed"], checks["replay_vs_eager"]
        if mode == "train":
            gate = (f"loss {agree['loss_rel_diff']:.3e}, gradients L2 "
                    f"{agree['grad_l2_overall']:.3e} (a layer's at most {agree['grad_l2_layer_max']:.3e}), parameters "
                    f"{agree['param_mean_diff_lr']:.4f} lr")
        else:
            gate = "max |diff| " + ", ".join(f"{k[:-len('_max_abs_diff')]} {v:.3e}"
                                             for k, v in agree.items() if k.endswith("_abs_diff"))
        twins = "; ".join(f"{k} x{e['calls']} " + ", ".join(
            f"{n[:-len('_max_rel_err')]} {v:.3e}" for n, v in e.items() if n != "calls")
            for k, e in checks["kernels_vs_twins"].items())
        log(f"[bench] 13a {mode} B={BATCH}: {r['value']:.2f} scenes/s (step median "
            f"{r['step_ms']['median']:.3f} ms, p90 {r['step_ms']['p90']:.3f}, "
            f"{r['step_ms']['n']} replays), {mode}_mfu {r[f'{mode}_mfu']:.4f} "
            f"({r['step_gflop_valid']:.1f} GFLOP a step; padded count "
            f"{r['model_gflop_padded']:.1f} GFLOP a forward); the first replay against the "
            f"copy's eager step: {gate}; that step's kernels against their twins (|err| / "
            f"max|twin|): {twins}; device busy {prof['device_busy_ms']:.3f} ms a replay, idle "
            f"{prof['idle_share']:.1%}, sparse "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["sparse_ms"].items())
            + ", dense " + ", ".join(f"{k} {v:.3f}" for k, v in prof["dense_ms"].items())
            + f"; peak {r['peak_memory_mib']:.1f} MiB; fed "
            f"{fed['split']} {fed['scenes_s']:.2f} scenes/s ({fed['iterations']} iterations, "
            f"fetch_load {fed['fetch_load_ms']:.1f} ms, fetch_copy {fed['fetch_copy_ms']:.1f}, "
            f"step {fed['step_ms']:.1f}; {fed['workers']} workers, nproc {r['nproc']}; overflow "
            f"{fed['overflow_max']:.4f}); "
            + "".join(f"occupancy {c['points']} points (live {c['live_voxel_frac']:.3f}) "
                      f"{c['eval_scenes_s']:.2f} scenes/s; " for c in r["occupancy_curve"])
            + "launches a step " + ", ".join(f"{k} {v:g}" for k, v in
                                               checks["launches_per_step"].items())
            + f"; {time.perf_counter() - t0:.1f} s wall")


def _step_gap(ref, got):
    """How far one step's (loss, gradients) lie from the reference's: the
    loss's relative difference, the gradients' L2 error overall and the
    largest of a parameter's L2 error over its layer's largest gradient
    norm (``check_step``'s readings)."""
    (r_loss, r_grads, _), (g_loss, g_grads, _) = ref, got
    layer_norm = {}
    for n, r in r_grads.items():
        layer = n.rsplit(".", 1)[0]
        layer_norm[layer] = max(layer_norm.get(layer, 0.0), r.norm().item())
    num = sum((g_grads[n] - r).norm().item() ** 2 for n, r in r_grads.items())
    den = sum(r.norm().item() ** 2 for r in r_grads.values())
    layer = max((g_grads[n] - r).norm().item() / max(layer_norm[n.rsplit(".", 1)[0]], 1e-30)
                for n, r in r_grads.items())
    return abs(g_loss - r_loss) / abs(r_loss), (num / den) ** 0.5, layer


def _stats_gap(ref, got):
    """The running statistics' largest |diff| over STATS_RTOL |ref| + 1e-5
    (at most 1 within phase 6's limit)."""
    return max(((got[2][n] - r).abs() / (STATS_RTOL * r.abs() + 1e-5)).max().item()
               for n, r in ref[2].items())


def _drift_run(spec, dev, ms, seed, aligned):
    """One run of 13b: the readings of each step, eager again and graph
    against the eager model, ``[(floor gap, graph gap)]``; from one state
    also the statistics' and the parameters' (``[(floor, graph)]``)."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    dd = batch_to_torch(make_batch(2, spec, seed=3 + 10 * seed, mean_size_arr=MEAN_SIZE,
                                   **SCENE_KW), spec, dev)
    models = [_graph_model(spec, dev, 4 + seed, dropout_override=0.0) for _ in range(3)]
    opts = [make_optimizer(m.parameters(), LR, WD) for m in models]
    graphs = StepGraphs(models[2], opts[2], ms)
    gaps, stats, drifts = [], [], []
    for step in range(DRIFT_STEPS):
        if aligned and step:
            for m, o in zip(models[1:], opts[1:]):
                copy_train_state(models[0], opts[0], m, o)
        metrics = [train_step(m, o, dd, ms)[0] for m, o in zip(models[:2], opts[:2])]
        metrics.append(graphs.train_step(dd)[0])
        torch.cuda.synchronize()
        states = [_step_state(m, model) for m, model in zip(metrics, models)]
        if aligned and not step:
            check_step("drift", ("eager", "eager again"), states[0], states[1])
            check_step("drift", ("eager", "graph"), states[0], states[2])
        gaps.append([_step_gap(states[0], s) for s in states[1:]])
        if aligned:
            stats.append([_stats_gap(states[0], s) for s in states[1:]])
            drifts.append([_param_drift(models[0], m, 1) for m in models[1:]])
    if graphs.captures != 1:
        raise AssertionError(f"13b: {graphs.captures} captures of one key")
    if not aligned:
        drifts = [[_param_drift(models[0], m, DRIFT_STEPS) for m in models[1:]]]
    return gaps, stats, drifts


def phase_drift(spec, dev):
    """13b: DRIFT_SEEDS runs, each of its own weights and 2-scene batch:
    the batch stepped DRIFT_STEPS times by an eager model, its eager twin
    and a graphed one (whose first step is the warm-up that captures), f32,
    TF32 off, dropout 0, from the same weights, under
    ``torch.use_deterministic_algorithms`` (``warn_only``; the ops it names
    as still nondeterministic are logged).  Left to its atomics, the BEV
    scatter's ``index_add_`` differs in the last bits from run to run, and
    a 2-scene step's gradients are ill-conditioned: from one state, one
    run's step-3 gradients read up to ~3e-2 apart, eager against eager or
    graph against eager alike, so a floor sampled in the same call could
    miss what the graph hit.  Deterministic sums take that noise away:
    eager again and the graph should then read the eager model's values
    exactly.  Adam, which moves an element by about lr whatever its
    gradient's size, turns any difference left into ~lr in the weights the
    next step runs on.  So the graph against eager is read beside eager
    against eager (the floor) in two designs, free-running and from one
    state (the eager model's state copied into the other two before each
    step), and their distributions over the runs are logged.  The first
    step, from the initial weights, is held to phase 6's limits.  From one
    state, at each later step the graph's largest loss and gradient
    readings over the runs are held to phase 6's limits or DRIFT_K x the
    floor's largest, the running statistics to phase 6's limits, and the
    parameters after every step, where a value baked in at the capture
    (Adam's step, its lr) would move every element by a share of lr, to
    ``_param_drift``'s limits and ``ADAM_MEAN``."""
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype

    import warnings

    import torch.utils.deterministic

    set_compute_dtype(None)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    names = ("loss rel. diff", "gradients' L2 error", "a layer's L2 error at most")
    limits = (LOSS_RTOL, GRAD_ALL, GRAD_LAYER)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for aligned in (False, True):
                runs = [_drift_run(spec, dev, ms, seed, aligned) for seed in range(DRIFT_SEEDS)]
                design = "from one state copied before each step" if aligned else "free-running"
                for step in range(DRIFT_STEPS):
                    parts = []
                    for i, name in enumerate(names):
                        floor = sorted(run[0][step][0][i] for run in runs)
                        graph = sorted(run[0][step][1][i] for run in runs)
                        parts.append(f"{name} eager again {floor[len(floor) // 2]:.3e} / "
                                     f"{floor[-1]:.3e}, graph {graph[len(graph) // 2]:.3e} / "
                                     f"{graph[-1]:.3e}")
                        limit = max(limits[i], DRIFT_K * floor[-1])
                        if aligned and step and not graph[-1] <= limit:
                            raise AssertionError(
                                f"13b: from one state at step {step + 1} the graph's {name} "
                                f"{graph[-1]:.3e} exceeds {DRIFT_K:g} x the floor's {floor[-1]:.3e}")
                    log(f"[drift] 13b f32 B=2, {DRIFT_SEEDS} runs {design}, step {step + 1} against "
                        f"the eager model (median / largest over the runs): " + "; ".join(parts))
                if aligned:
                    stats = [s for run in runs for s in run[1]]
                    drifts = [d for run in runs for d in run[2]]
                    log(f"[drift] 13b from one state, over the runs and steps: the running "
                        f"statistics' largest |diff| over phase 6's limit, eager again "
                        f"{max(e for e, _ in stats):.3f}, graph {max(g for _, g in stats):.3f} "
                        f"(limit 1); the parameters' mean |diff| after a step, eager again at most "
                        f"{max(e for e, _ in drifts):.4f} lr, graph at most "
                        f"{max(g for _, g in drifts):.4f} lr (limit {ADAM_MEAN:g})")
                    if not max(g for _, g in stats) <= 1:
                        raise AssertionError("13b: graph and eager running statistics disagree")
                    if not max(g for _, g in drifts) <= ADAM_MEAN:
                        raise AssertionError("13b: graph and eager parameters drift apart")
                else:
                    log(f"[drift] 13b free-running, the parameters after step {DRIFT_STEPS}: mean "
                        f"|diff| against the eager model's, eager again "
                        + ", ".join(f"{run[2][0][0]:.4f}" for run in runs) + " lr, graph "
                        + ", ".join(f"{run[2][0][1]:.4f}" for run in runs) + " lr")
            left = sorted({str(w.message).split("\n")[0][:160] for w in seen
                           if "deterministic" in str(w.message)})
            log("[drift] 13b ops that torch.use_deterministic_algorithms left nondeterministic: "
                + ("; ".join(left) or "none"))
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


# ---------------------------------------------------------------- phase 14
FEED_BATCH, FEED_BATCHES = 8, 6  # 14a-b: an epoch of 6 batches of 8 from a fake root
STRESS_BATCHES = 16  # 14c: 2-scene batches, a list the producer runs through at once
STRESS_SLEEP_CYCLES = 50_000_000  # 14c: ~25 ms of the card's clock before each replay


class _Kept:
    """A loader that keeps each batch it yields (on the prefetcher's
    thread) for the consumer to hold its finished tensors against."""

    def __init__(self, loader):
        self.loader, self.kept = loader, collections.deque()

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.kept.append(batch)
            yield batch


def _differing(got: dict, want: dict):
    """The names of the tensors of two data dicts that differ in dtype,
    shape or any bit (``torch.equal``)."""
    from instancerefer_tpu_torch.data.host import _named_tensors

    got, want = dict(_named_tensors(got)), dict(_named_tensors(want))
    if got.keys() != want.keys():
        return sorted(got.keys() ^ want.keys())
    return [n for n, w in want.items()
            if got[n].dtype != w.dtype or got[n].shape != w.shape or not torch.equal(got[n], w)]


def _checksums(dd: dict) -> torch.Tensor:
    """Each tensor's bytes summed as int64, on its device: exact, so the
    card's and the host's agree bit for bit."""
    from instancerefer_tpu_torch.data.host import _named_tensors

    return torch.stack([t.reshape(-1).view(torch.uint8).long().sum()
                        for _, t in _named_tensors(dd)])


def phase_prefetch(spec, dev):
    """14a: an epoch of a fake ScanRefer root (augmented train split, the
    CLIs' 4 build threads) through ``Solver._feed`` on its step graphs,
    f32, TF32 off, dropout 0, under ``torch.use_deterministic_algorithms``:
    every batch the prefetcher staged and the solver ``finish``ed into the
    graph's inputs equals ``batch_to_torch(batch, spec, card)`` in every bit
    (``torch.equal``), before the step reads it; the fed split.  14b: the
    same epoch from the same weights fed synchronously (``batch_to_torch``
    of each batch into the graph's inputs, ``out=``) writes the same
    losses, exactly.  14c: 2-scene batches from a list, which the producer
    runs through as fast as the fences let it, and a slow consumer (a
    ``torch.cuda._sleep`` before each eval replay, no host sync): the
    checksum of each batch's finished tensors taken on the card, read at
    the end, equals the host's of ``batch_to_torch``: no staging set was
    rewritten before its ``finish`` read it."""
    import warnings

    import torch.utils.deterministic

    from instancerefer_tpu_torch.data import dataset as D
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.prefetch import DevicePrefetcher
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import Solver, make_optimizer
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    root = tempfile.mkdtemp(prefix="prefetch_smoke_")
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)

    def loader():
        ds = D.ScannetReferenceDataset(D.get_scanrefer(root, "train"), "train", data_root=root,
                                       num_points=SCENE_KW["num_points"])
        return D.PaddedLoader(ds, spec, FEED_BATCH, shuffle=True, seed=0, num_workers=4)

    set_compute_dtype(None)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        write_fake_scanrefer(root, np.random.default_rng(4), {"train": FEED_BATCHES}, FEED_BATCH,
                             scenes={"train": range(2)})
        kept = _Kept(loader())
        checked = []

        class Checked(Solver):
            def _load(self, staged, phase):
                dd = super()._load(staged, phase)
                bad = _differing(dd, batch_to_torch(kept.kept.popleft(), spec, dev))
                if bad:
                    raise AssertionError(f"14a: batch {len(checked)}: the prefetched batch "
                                         f"differs from batch_to_torch's in {bad[:6]}")
                checked.append(len(bad))
                return dd

        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            solver = Checked(_graph_model(spec, dev, 14, dropout_override=0.0), MEAN_SIZE, spec,
                             dev, lr=LR, wd=WD, output_dir=os.path.join(root, "out"))
            solver.epoch, solver.verbose = 1, 1 << 30  # one epoch, no iter report
            solver._feed(kept, "train", 0)
        fed = solver.log["train"]
        if len(checked) != FEED_BATCHES or solver.graphs is None or solver.graphs.captures != 1:
            raise AssertionError(f"14a: {len(checked)} batches checked, graphs "
                                 f"{solver.graphs and solver.graphs.captures} captures")
        step_ms = [(i - f) * 1e3 for i, f in zip(fed["iter_time"], fed["fetch"])]
        log(f"[prefetch] 14a f32 B={FEED_BATCH}, an epoch of {FEED_BATCHES} augmented batches "
            f"(4 build threads) through Solver._feed on its graphs: every batch staged, copied "
            f"and finished into the graph's inputs equals batch_to_torch's in every bit")
        log("[prefetch] fed split a batch after the first (the capture), ms: " + ", ".join(
            f"{k} {statistics.median(fed[k][1:]) * 1e3:.2f}" for k in
            ("fetch", "fetch_load", "fetch_copy", "fetch_stage"))
            + f", step {statistics.median(step_ms[1:]):.2f}; the first iteration: fetch "
            f"{fed['fetch'][0] * 1e3:.1f}, step {step_ms[0]:.1f}")

        model = _graph_model(spec, dev, 14, dropout_override=0.0)
        graphs = StepGraphs(model, make_optimizer(model.parameters(), LR, WD), ms)
        losses = []
        for batch in loader():
            step = graphs.graphs.get(graphs.key("train", batch["lang_feat"].shape[1]))
            dd = batch_to_torch(batch, spec, dev, out=step.inputs if step else None)
            losses.append(float(graphs.train_step(dd)[0]["loss"]))
        if losses != fed["loss"]:
            raise AssertionError(f"14b: the prefetched epoch's losses {fed['loss']}, the "
                                 f"synchronous feed's {losses}")
        log(f"[prefetch] 14b the same epoch fed synchronously (batch_to_torch into the graph's "
            f"inputs), deterministic algorithms: the same {len(losses)} losses, exactly ("
            + ", ".join(f"{x:.6f}" for x in losses) + ")")
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)

    set_compute_dtype("bfloat16")
    try:
        host = [make_batch(2, spec, seed=100 + i, mean_size_arr=MEAN_SIZE, **SCENE_KW)
                for i in range(STRESS_BATCHES)]
        graphs = StepGraphs(_graph_model(spec, dev, 15), None, ms)
        sums, finish_s = [], []
        torch.cuda.synchronize()
        start = time.perf_counter()
        with DevicePrefetcher(host, spec, dev) as fed:
            for ready in fed:
                t0 = time.perf_counter()
                with ready as staged:
                    dd = graphs.load(staged, spec, "eval")
                finish_s.append(time.perf_counter() - t0)
                sums.append(_checksums(dd))  # on the consumer's stream, after finish
                torch.cuda._sleep(STRESS_SLEEP_CYCLES)
                graphs.eval_step(dd)
            queued = time.perf_counter() - start
        torch.cuda.synchronize()
        ran = time.perf_counter() - start
        got = torch.stack(sums).cpu()
        want = torch.stack([_checksums(batch_to_torch(b, spec, "cpu")) for b in host])
        bad = [i for i in range(STRESS_BATCHES) if not torch.equal(got[i], want[i])]
        log(f"[prefetch] 14c bf16 B=2, {STRESS_BATCHES} batches from a list, a "
            f"{STRESS_SLEEP_CYCLES:.0e}-cycle sleep before each eval replay: the host queued "
            f"them in {queued:.3f} s, the card ran them in {ran:.3f} s; the consumer's finish "
            f"into the graph's inputs {statistics.median(finish_s[1:]) * 1e3:.2f} ms a batch "
            f"(median; the same tensors as at B = 64, no loader threads); the checksums of "
            f"{STRESS_BATCHES - len(bad)} of {STRESS_BATCHES} batches finished on the card equal "
            f"the host's")
        if bad or len(sums) != STRESS_BATCHES:
            raise AssertionError(f"14c: {len(sums)} batches, checksums differ at {bad}: a "
                                 f"staging set was rewritten before its finish read it")
    finally:
        set_compute_dtype(None)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops import gather_conv as gc_mod
    from instancerefer_tpu_torch.ops import voxelize

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    if not voxelize.native_available():
        raise AssertionError("the port's native voxelizer did not build; the host runs numpy")
    log(f"[device] host voxelizer: the port's own native library {voxelize.native_library_path()}")
    t0 = time.perf_counter()
    libs = gc_mod.build()
    log(f"[build] {', '.join(sorted(libs))} ready in {time.perf_counter() - t0:.1f} s")
    for stem, lib in sorted(libs.items()):
        report = open(lib[:-3] + ".log").read()
        spills = [line.strip() for line in report.splitlines()
                  if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
        stem_regs = [f"{m.group(1)}{m.group(2) or ''} {r}" for name, r in re.findall(
            r"Compiling entry function '(\w+)'.*?Used (\d+) registers", report, re.S)
            for m in [re.search(STEM_KERNEL, name)] if m]
        log(f"[build] {stem}: {len(regs)} kernels, at most {max(regs)} registers, "
            f"{len(spills)} with spills (-Xptxas -v); the stem kernels' registers: "
            + (", ".join(stem_regs) or "none"))
        if spills:
            raise AssertionError(f"{stem}: ptxas spills registers: {spills}")

    spec = BatchSpec(**SPEC_KW)
    t0 = time.perf_counter()
    batches = [make_batch(BATCH, spec, seed=s, mean_size_arr=MEAN_SIZE, **SCENE_KW)
               for s in (0, 1, 2)]
    dds = [batch_to_torch(b, spec, dev) for b in batches]
    log(f"[host] 3 batches of {BATCH} scenes built in {time.perf_counter() - t0:.1f} s")

    k1 = phase_kernel(batches[0], dev)
    phase_parity(spec, dev)
    phase_full(spec, dev, dds, make_model(spec, seed=2).to(dev))
    bwd = phase_bwd_kernels(batches[0], dev)
    phase_train_parity(spec, dev)
    launches, _ = phase_train(spec, dev, dds)
    del dds
    phase_cli()
    t9 = time.perf_counter()
    stems = phase_stem_widths(batches[0], dev)
    fused = phase_projection(dev, phase_enet(dev))
    mv = phase_multiview(dev, fused)
    log(f"[phase 9] stem widths, ENet, projection and the multiview input path: "
        f"{time.perf_counter() - t9:.1f} s wall")
    t10 = time.perf_counter()
    phase_ddp(dev)
    phase_ddp_cli(dev, [batch_to_torch(b, spec, dev) for b in batches])
    phase_sanity(dev)
    log(f"[phase 10] data parallelism on the card (2 gloo ranks; the train CLI at world "
        f"size 1 over NCCL) and the overfit check: {time.perf_counter() - t10:.1f} s wall")
    t11 = time.perf_counter()
    phase_prepare(dev)
    phase_loss_variants(dev)
    log(f"[phase 11] raw ScanNet scans to a train step and eval forward, the loss variants "
        f"and visualize: {time.perf_counter() - t11:.1f} s wall")
    t12 = time.perf_counter()
    phase_graphs(spec, dev, batches)
    log(f"[phase 12] the steps' CUDA graphs beside the eager steps: "
        f"{time.perf_counter() - t12:.1f} s wall")
    t13 = time.perf_counter()
    phase_bench()
    phase_drift(spec, dev)
    log(f"[phase 13] the bench at B={BATCH} (eval and train) and graph against eager over one "
        f"batch stepped {DRIFT_STEPS} times: {time.perf_counter() - t13:.1f} s wall")
    t14 = time.perf_counter()
    phase_prefetch(spec, dev)
    log(f"[phase 14] the prefetcher against batch_to_torch, a synchronous feed and a slow "
        f"consumer: {time.perf_counter() - t14:.1f} s wall")

    entries = (
        ("gather_conv", "gather_conv.cu", 51, k1),
        ("subm_conv_bwd", "subm_conv_bwd.cu", 267, bwd["subm_conv_bwd"]),
        ("conv_dw", "conv_dw.cu", 440, bwd["conv_dw"]),
    )
    rows = [(name, src, line, launches[name], totals) for name, src, line, totals in entries]
    rows.insert(1, ("down_dx (K1's route: the down convs' dX over the lists, among K1's "
                    "launches)", "gather_conv.cu", 51, launches["down_dx"], bwd["down_dx"]))
    rows.append(("dw_lists (the list pass at the downs, shared by their dX and K3)",
                 "conv_dw.cu", 440, launches["dw_lists"], bwd["dw_lists"]))
    for config, cin in MV_WIDTHS.items():  # the stems at the other input widths
        for name, src, line, _ in entries[::2]:
            rows.append((f"{name} at the stems, Cin {cin} ({config})", src, line,
                         mv[config][1][name], stems[name, cin]))
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"instancerefer_tpu_torch/csrc/{src}",
        "replaces": f"instancerefer_tpu/ops/pallas_conv.py:{line}",
        "launches": n,
        **totals.entry(),
    } for name, src, line, n, totals in rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
