"""Training solver, counterpart of ``instancerefer_tpu/train/solver.py``: the
train step, its schedules, and the ``Solver`` that runs the epoch loop with
the reference's reports and checkpoints.

* ``make_optimizer``: ``torch.optim.Adam`` with L2 weight decay folded into
  the gradient — the optax chain ``add_decayed_weights -> scale_by_adam ->
  lr`` of the JAX package, with the same defaults (betas 0.9/0.999, eps 1e-8);
  on a card capturable, its lr a tensor on the card.
* ``make_scheduler``: ``MultiStepLR`` over epochs, stepped once per epoch;
  JAX's per-step boundaries at ``epoch * steps_per_epoch`` give the same lr.
  A tensor lr is written in place.
* ``bn_momentum_for_epoch``: the reference's BNMomentumScheduler.
* ``train_step``: train-mode forward -> ``get_loss`` -> backward -> Adam ->
  ``get_eval``, eagerly (``step_graph.train_body``).
* ``Solver``: the epoch loop (resumable from its epoch counter), the feed
  through ``data/prefetch.DevicePrefetcher`` (depth 2, as the JAX solver's
  ``_device_prefetch``) with the host-side capacity-overflow log, the iter /
  epoch / best report templates of the reference (``lib/solver.py:23-60``),
  ``log.txt``, ``scalars.jsonl`` (whose train records also carry the lr),
  ``best.txt``, optional tensorboardX, best-model selection on val
  ``iou_rate_0.25``, and the reference's three checkpoint roles:
  ``model_last.pth`` every epoch, ``model.pth`` on a new best, and
  ``checkpoint.tar`` = {epoch, model_state_dict, optimizer_state_dict, best}
  at the end and on Ctrl-C.  Every file holds the reference's layout
  (``utils/convert``).  Fetch time is the host clock; each iter report is
  followed by its split: the wait for a staged batch (``fetch_load``), the
  consumer's time in ``finish`` (``fetch_copy``), and the producer thread's
  time staging a batch and issuing its copy (``fetch_stage``), which
  overlaps the steps.

How a step runs is chosen once, from the device and the world size
(``step_graph.choose``), and logged: on a card at world size 1 the train and
eval steps replay CUDA graphs (``step_graph.StepGraphs``, one per language
grid, as the JAX package compiles one program per grid); on the CPU, and
data-parallel, they run eagerly.  Either way a batch comes staged from the
prefetcher's thread, its copy to the card made on a side stream while the
steps before it run, and is ``finish``ed on the card at its step: straight
into its graph's inputs, or into new tensors for an eager step.
Every step is timed per phase (forward with the loss, backward with Adam,
eval): a graph's step by the CUDA events its graph records at the body's
marks (``step_graph.StepMarks``; a key's first step, its eager warm-up, by
its own), an eager step with CUDA events on a card and the host clock on
the CPU; the iter report's last line says which.  Every time is read once
the step's metrics are on the host.

Data-parallel (a process group of world size > 1, ``parallel/distributed``):
the ``Solver`` wraps the model in ``DistributedDataParallel``; each rank
feeds its own loader shard, and every scalar that the logs, ``best.txt`` and
the best-model choice read is that of the global batch, equal on every rank
(the means of ``get_loss``/``get_eval``, the Acc@IoU hit and valid counts
summed in ``train_metrics``), so every rank picks the same best epoch.  Only
rank 0 makes the run directory and writes logs, tensorboard and
checkpoints; every rank loads them.  At world size 1 nothing is wrapped and
no collective runs.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from instancerefer_tpu_torch.data.host import finish
from instancerefer_tpu_torch.data.prefetch import DevicePrefetcher
from instancerefer_tpu_torch.parallel.distributed import (
    all_reduce_max,
    all_reduce_sum,
    is_main,
    world_size,
)
from instancerefer_tpu_torch.train.step_graph import METRIC_KEYS, StepMarks, eval_body, train_body
from instancerefer_tpu_torch.train.step_graph import choose as choose_steps
from instancerefer_tpu_torch.utils.convert import (
    from_reference,
    load_reference_state_dict,
    to_reference,
    to_reference_state_dict,
)
from instancerefer_tpu_torch.utils.eta import decode_eta
from instancerefer_tpu_torch.utils.profiling import span

ITER_REPORT_TEMPLATE = """
-------------------------------iter: [{epoch_id}: {iter_id}/{total_iter}]-------------------------------
[loss] train_loss: {train_loss}
[loss] train_ref_loss: {train_ref_loss}
[loss] train_lang_loss: {train_lang_loss}
[loss] train_seg_loss: {train_seg_loss}
[loss] train_lang_acc: {train_lang_acc}
[sco.] train_ref_acc: {train_ref_acc}
[sco.] train_seg_acc: {train_seg_acc}
[sco.] train_iou_rate_0.25: {train_iou_rate_25}, train_iou_rate_0.5: {train_iou_rate_5}
[info] mean_fetch_time: {mean_fetch_time}s
[info] mean_forward_time: {mean_forward_time}s
[info] mean_backward_time: {mean_backward_time}s
[info] mean_eval_time: {mean_eval_time}s
[info] mean_iter_time: {mean_iter_time}s
[info] ETA: {eta_h}h {eta_m}m {eta_s}s
"""

# the fetch of the iter report in its parts, and where its phase times
# come from, logged after it
FETCH_SPLIT_TEMPLATE = """[info] mean_fetch_load_time: {mean_load_time}s
[info] mean_fetch_copy_time: {mean_copy_time}s
[info] mean_fetch_stage_time: {mean_stage_time}s
[info] phase_times: {phase_times}"""

EPOCH_REPORT_TEMPLATE = """
---------------------------------summary---------------------------------
[val]   val_loss: {val_loss}
[val]   val_lang_loss: {val_lang_loss}
[val]   val_lang_acc: {val_lang_acc}
[val]   val_seg_acc: {val_seg_acc}
[val]   val_ref_acc: {val_ref_acc}
[val]   val_iou_rate_0.25: {val_iou_rate_25}, val_iou_rate_0.5: {val_iou_rate_5}
"""

BEST_REPORT_TEMPLATE = """
--------------------------------------best--------------------------------------
[best] epoch: {epoch}
[loss] loss: {loss}
[loss] ref_loss: {ref_loss}
[loss] lang_loss: {lang_loss}
[loss] lang_acc: {lang_acc}
[sco.] ref_acc: {ref_acc}
[sco.] iou_rate_0.25: {iou_rate_25}, iou_rate_0.5: {iou_rate_5}
"""

# the top-level submodules a ``use_pretrained`` warm start copies
PRETRAINED_MODULES = ("lang", "attribute", "relation", "scene")
MOMENTS = ("exp_avg", "exp_avg_sq")
# how an Adam runs rather than what it computes: a loaded state keeps the
# optimizer's own
ADAM_RUN_KEYS = ("capturable", "foreach", "fused", "differentiable")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, wd: float) -> torch.optim.Adam:
    """Adam over ``params``.  On a card (``params`` on a CUDA device) it is
    ``capturable`` and its lr a 0-d tensor there, which ``make_scheduler``
    writes in place, so a captured step reads the current lr; on the CPU
    the lr is a float."""
    params = list(params)
    if not (params and params[0].is_cuda):
        return torch.optim.Adam(params, lr=lr, weight_decay=wd)
    optimizer = torch.optim.Adam(params, lr=torch.tensor(float(lr), device=params[0].device),
                                 weight_decay=wd, capturable=True)
    for group in optimizer.param_groups:  # the schedule's base, not the float32 tensor's value
        group["initial_lr"] = float(lr)
    return optimizer


def make_scheduler(optimizer: torch.optim.Optimizer, lr_decay_step: Optional[Sequence[int]],
                   lr_decay_rate: Optional[float], start_epoch: int = 0
                   ) -> torch.optim.lr_scheduler.MultiStepLR:
    """lr x rate at each milestone epoch; constant without both.  The lr is
    set to that of epoch ``start_epoch`` from each group's initial lr (a
    float), so a resumed run rebuilds its schedule from the epoch alone; a
    tensor lr keeps its tensor and takes each value in place."""
    for group in optimizer.param_groups:
        initial = float(group.setdefault("initial_lr", float(group["lr"])))
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(initial)
        else:
            group["lr"] = initial
    if lr_decay_step and lr_decay_rate:
        steps = lr_decay_step if isinstance(lr_decay_step, (list, tuple)) else [lr_decay_step]
        sched = torch.optim.lr_scheduler.MultiStepLR(optimizer, [int(e) for e in steps],
                                                     float(lr_decay_rate))
    else:
        sched = torch.optim.lr_scheduler.MultiStepLR(optimizer, [], 1.0)
    with warnings.catch_warnings():
        # "lr_scheduler.step() before optimizer.step()": on purpose here
        warnings.simplefilter("ignore", UserWarning)
        for _ in range(start_epoch):
            sched.step()
    return sched


def bn_momentum_for_epoch(epoch: int, bn_decay_step, bn_decay_rate) -> float:
    """max(0.5 * rate^(epoch // step), 0.001); 0.1 without a schedule."""
    if not (bn_decay_step and bn_decay_rate):
        return 0.1
    return max(0.5 * bn_decay_rate ** (epoch // bn_decay_step), 0.001)


def metrics_to_host(metrics: Dict[str, torch.Tensor], step: Optional[int] = None
                    ) -> Dict[str, float]:
    """Every scalar of a step in one device -> host transfer: the stack and
    cast issued (``ir.to_host.issue``), then the read, which waits for the
    step's last kernel (``ir.to_host.wait``); ``step`` numbers the span."""
    with span("ir.to_host", **({} if step is None else {"step": step})):
        keys = list(metrics)
        with span("ir.to_host.issue"):
            stacked = torch.stack([metrics[k].float() for k in keys])
        with span("ir.to_host.wait"):
            values = stacked.cpu().tolist()
        return dict(zip(keys, values))


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, dd: dict,
               mean_size: torch.Tensor, bn_momentum: float = 0.1,
               timer: Optional[StepMarks] = None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Train-mode forward -> ``get_loss`` -> backward -> ``optimizer.step()``
    -> ``get_eval``, eagerly (``step_graph.train_body``).  Returns (metrics,
    the step's outputs).  The gradients stay in ``.grad`` until the next
    step.  ``timer`` marks the bounds of forward (with the loss), backward
    (with Adam) and eval.  ``model`` may be a ``DistributedDataParallel``
    wrapper."""
    model.train()
    getattr(model, "module", model).set_bn_momentum(bn_momentum)
    return train_body(model, optimizer, dd, mean_size, timer.mark if timer is not None else None)


def _portable(optimizer_state: dict) -> dict:
    """An optimizer state_dict as a CPU Adam holds it: every tensor on the
    CPU, the param groups' tensors (a card's lr) as floats."""
    state = {idx: {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                   for k, v in st.items()} for idx, st in optimizer_state["state"].items()}
    groups = [{k: float(v) if isinstance(v, torch.Tensor) else v for k, v in g.items()}
              for g in optimizer_state["param_groups"]]
    return {"state": state, "param_groups": groups}


def _named_moments(optimizer_state: dict, names: List[str], convert) -> dict:
    """An optimizer state_dict with its Adam moments passed through
    ``convert`` ({name: tensor} -> {name: tensor}), keyed by parameter name."""
    state = {}
    for idx, st in optimizer_state["state"].items():
        st = dict(st)
        name = names[int(idx)]
        for m in MOMENTS:
            if m in st:
                st[m] = convert({name: st[m]})[name]
        state[idx] = st
    return {"state": state, "param_groups": optimizer_state["param_groups"]}


class Solver:
    def __init__(
        self,
        model: torch.nn.Module,
        mean_size_arr: np.ndarray,
        spec,
        device,
        *,
        lr: float = 1e-3,
        wd: float = 1e-5,
        lr_decay_step=(15, 20),
        lr_decay_rate: float = 0.1,
        bn_decay_step=None,
        bn_decay_rate=None,
        stamp: str = "run",
        output_dir: str = "outputs",
        start_val: int = 0,
        task=None,
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        # the module a train step runs: DDP's wrapper when data-parallel
        self.train_model = self.model
        if world_size() > 1:
            from torch.nn.parallel import DistributedDataParallel

            # every parameter takes a gradient in every config the port
            # builds; the running statistics come from global sums, equal on
            # every rank, so no buffer is broadcast
            self.train_model = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                broadcast_buffers=False)
        self.main = is_main()
        self.spec = spec
        self.mean_size = torch.tensor(np.asarray(mean_size_arr), dtype=torch.float32,
                                      device=self.device)
        self.optimizer = make_optimizer(self.model.parameters(), lr, wd)
        self.graphs, self._step_path = choose_steps(self.model, self.optimizer, self.mean_size,
                                                    task)
        self.lr_decay_step = lr_decay_step
        self.lr_decay_rate = lr_decay_rate
        self.bn_decay_step = bn_decay_step
        self.bn_decay_rate = bn_decay_rate
        self.stamp = stamp
        # validation (and best-model selection) starts at epoch start_val
        self.start_val = start_val
        self.root = os.path.join(output_dir, stamp)
        if self.main:
            os.makedirs(self.root, exist_ok=True)
        self.log_path = os.path.join(self.root, "log.txt")
        self.scalars_path = os.path.join(self.root, "scalars.jsonl")
        self.timer = StepMarks(self.device)  # an eager step's phases

        # tensorboard writers (reference lib/solver.py:96-102); optional dep
        self._log_writer = {}
        try:
            from tensorboardX import SummaryWriter

            for phase in ("train", "val") if self.main else ():
                d = os.path.join(self.root, "tensorboard", phase)
                os.makedirs(d, exist_ok=True)
                self._log_writer[phase] = SummaryWriter(d)
        except ImportError:
            pass

        self.best = self._initial_best()
        self.epochs_done = 0  # the epoch counter a checkpoint resumes from
        self.steps = {"train": 0, "val": 0}  # steps run by this solver
        self._global_iter_id = 0
        self._total_iter = {"train": 0}
        self._iters_per_epoch = 1
        self._val_len = 0
        self.init_log()
        self._log("steps: " + self._step_path)

    # ------------------------------------------------------------------- loop
    def __call__(self, dataloader: Dict[str, Iterable], epoch: int, verbose: int):
        self.epoch = epoch
        self.verbose = verbose
        self._total_iter["train"] = len(dataloader["train"]) * epoch
        self._iters_per_epoch = max(len(dataloader["train"]), 1)
        self._val_len = len(dataloader["val"])  # for the ETA's val term

        # resume: the epoch counter of a restored checkpoint sets the lr, the
        # BN momentum and the iteration count (reference lib/solver.py:373-381)
        start_epoch = self.epochs_done
        self.scheduler = make_scheduler(self.optimizer, self.lr_decay_step,
                                        self.lr_decay_rate, start_epoch)
        self._global_iter_id = start_epoch * len(dataloader["train"])
        epoch_id = start_epoch
        for epoch_id in range(start_epoch, epoch):
            try:
                self._log(f"epoch {epoch_id + 1} starting...")
                bn_momentum = bn_momentum_for_epoch(
                    epoch_id, self.bn_decay_step, self.bn_decay_rate
                )
                self._feed(dataloader["train"], "train", epoch_id, bn_momentum)
                self.scheduler.step()
                self._log("saving last models...\n")
                self.save_checkpoint("model_last")
                if epoch_id + 1 >= self.start_val:
                    self.init_log()
                    self._feed(dataloader["val"], "val", epoch_id)
                self.epochs_done = epoch_id + 1
            except KeyboardInterrupt:
                self._finish(epoch_id)
                return
        self._finish(epoch_id)

    def _report_overflow(self, phase, overflow_log):
        """Epoch-wide capacity-overflow fractions (every batch, not just the
        first): a capacity bust anywhere in the epoch is surfaced here.
        Data-parallel, over every rank's batches: the sums and counts are
        added and the maxima taken over the ranks first."""
        keys = ("scene", "inst", "cand")
        sums = [float(np.sum(overflow_log.get(k, []))) for k in keys]
        counts = [float(len(overflow_log.get(k, []))) for k in keys]
        maxes = [float(np.max(overflow_log[k])) if overflow_log.get(k) else 0.0 for k in keys]
        if world_size() > 1:
            def reduce(fn, values):
                return fn(torch.tensor(values, dtype=torch.float64, device=self.device)).tolist()
            sums, counts = reduce(all_reduce_sum, [sums, counts])
            maxes = reduce(all_reduce_max, maxes)
        if not counts[0]:
            return
        (so, io_, cand_mean), (so_max, io_max, cand_max) = (
            [s / max(n, 1.0) for s, n in zip(sums, counts)], maxes)
        if max(so, io_, so_max, io_max) > 0.01:
            self._log(
                f"WARNING: [{phase}] voxel capacity overflow over the epoch "
                f"(scene mean {so:.1%} / max {so_max:.1%}, instance mean "
                f"{io_:.1%} / max {io_max:.1%}) — raise scene_caps/inst_caps "
                f"in the TPU config section to avoid dropped voxels"
            )
        if counts[2] and cand_max > 0:
            self._log(
                f"WARNING: [{phase}] candidate capacity overflow over the "
                f"epoch (mean {cand_mean:.2%} / max "
                f"{cand_max:.2%} of filtered instances dropped) — "
                f"the reference keeps every filtered candidate; raise "
                f"max_candidates in the TPU config section"
            )

    # ---------------------------------------------- the model's own parts
    # (InstanceRefer's here; train/pointgroup.PointGroupSolver has its own)
    metric_keys = METRIC_KEYS
    best_key = "iou_rate_0.25"  # the val metric a new best model is picked by
    best_higher = True  # whether a higher value of it is better

    def _initial_best(self) -> dict:
        return {
            "epoch": 0, "loss": float("inf"), "ref_loss": float("inf"),
            "lang_loss": float("inf"), "seg_loss": float("inf"),
            "lang_acc": -float("inf"), "ref_acc": -float("inf"),
            "seg_acc": -float("inf"),
            "iou_rate_0.25": -float("inf"), "iou_rate_0.5": -float("inf"),
        }

    def _eager_train_step(self, dd: dict, bn_momentum: float) -> Dict[str, torch.Tensor]:
        return train_step(self.train_model, self.optimizer, dd, self.mean_size, bn_momentum,
                          self.timer)[0]

    def _accumulate(self, phase: str, metrics: Dict[str, float]) -> None:
        """One step's metrics into the phase's log."""
        for k in METRIC_KEYS:
            self.log[phase][k].append(metrics[k])
        for k in ("iou25_hits", "iou5_hits", "iou_count"):
            self.log[phase][k] += metrics[k]
        denom = max(self.log[phase]["iou_count"], 1.0)
        self.log[phase]["iou_rate_0.25"] = self.log[phase]["iou25_hits"] / denom
        self.log[phase]["iou_rate_0.5"] = self.log[phase]["iou5_hits"] / denom

    def _pooled(self, phase: str) -> Dict[str, float]:
        """The phase's pooled metrics that are not means of steps."""
        return {"iou_rate_0.25": self.log[phase]["iou_rate_0.25"],
                "iou_rate_0.5": self.log[phase]["iou_rate_0.5"]}

    def _to_file(self) -> dict:
        """The model's state dict in the layout the checkpoints hold (the
        reference's)."""
        return to_reference_state_dict(self.model)

    def _load_file_state(self, state: dict) -> None:
        load_reference_state_dict(self.model, state)

    def _moments_to_file(self, opt_state: dict) -> dict:
        return _named_moments(opt_state, self._param_names(), to_reference)

    def _moments_from_file(self, opt_state: dict) -> dict:
        return _named_moments(opt_state, self._param_names(), from_reference)

    def _eval_step(self, dd: dict) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return eval_body(self.model, dd, self.mean_size, self.timer.mark)[0]

    def _load(self, staged: dict, phase: str) -> dict:
        """``finish`` of a staged batch: into its graph's inputs, or new
        tensors for an eager step."""
        if self.graphs is not None:
            return self.graphs.load(staged, self.spec, "train" if phase == "train" else "eval")
        with span("ir.load", step=sum(self.steps.values())):
            return finish(staged, self.spec)

    def _graph_step(self, dd: dict, phase, bn_momentum: float) -> dict:
        """A loaded batch through the graph of its key: its metrics."""
        if phase == "train":
            metrics, _ = self.graphs.train_step(dd, bn_momentum)
        else:
            metrics, _ = self.graphs.eval_step(dd)
        return metrics

    def _feed(self, loader, phase, epoch_id, bn_momentum: float = 0.1):
        overflow_log = {"scene": [], "inst": []}
        graphs = self.graphs is not None
        # the producer is stopped and joined on leaving the block, also on a
        # break, an exception in a step or Ctrl-C
        with DevicePrefetcher(loader, self.spec, self.device,
                              overflow_log=overflow_log) as batches:
            fetch_start = time.perf_counter()
            for ready in batches:
                start = time.perf_counter()
                with ready as staged:
                    dd = self._load(staged, phase)
                copy = time.perf_counter() - start
                fetch = time.perf_counter() - fetch_start
                start = time.perf_counter()
                self.timer.begin()
                if graphs:
                    metrics = self._graph_step(dd, phase, bn_momentum)
                elif phase == "train":
                    metrics = self._eager_train_step(dd, bn_momentum)
                else:
                    metrics = self._eval_step(dd)
                metrics = metrics_to_host(metrics, sum(self.steps.values()))
                phases = self.graphs.phase_seconds() if graphs else self.timer.seconds()
                step_time = time.perf_counter() - start
                self.steps[phase] += 1
                self.log[phase]["fetch"].append(fetch)
                self.log[phase]["fetch_load"].append(ready.load)
                self.log[phase]["fetch_copy"].append(copy)
                self.log[phase]["fetch_stage"].append(ready.stage)
                self.log[phase]["forward"].append(phases[0])
                self.log[phase]["backward"].append(phases[1] if phase == "train" else 0.0)
                self.log[phase]["eval"].append(phases[-1])

                self._accumulate(phase, metrics)

                self.log[phase]["iter_time"].append(self.log[phase]["fetch"][-1] + step_time)
                if phase == "train":
                    if (self._global_iter_id + 1) % self.verbose == 0:
                        self._train_report(epoch_id)
                        self._dump_log("train")
                        self.init_log()
                    self._global_iter_id += 1
                fetch_start = time.perf_counter()

        # the producer appended to the log; it has been joined
        self._report_overflow(phase, overflow_log)
        if phase == "val":
            self._dump_log("val")
            self._epoch_report(epoch_id)
            pooled = self._pooled("val")
            means = {k: float(np.mean(self.log["val"][k])) if self.log["val"][k] else 0.0
                     for k in self.metric_keys}
            cur = pooled.get(self.best_key, means.get(self.best_key))
            best = self.best[self.best_key]
            if (cur > best) if self.best_higher else (cur < best):
                self._log(f"best {self.best_key} achieved: {cur}")
                self.best.update(means)
                self.best.update(pooled)
                self.best["epoch"] = epoch_id + 1
                self._log("saving best models...\n")
                self.save_checkpoint("model")

    # ------------------------------------------------------------ checkpoints
    def _param_names(self) -> List[str]:
        return [n for n, _ in self.model.named_parameters()]

    def save_checkpoint(self, name: str, with_opt: bool = False) -> str:
        """``<name>.pth`` (the model's state_dict) or, ``with_opt``,
        ``<name>.tar`` (epoch, state_dict, optimizer state, best), in the
        reference's layout; written whole or not at all, by rank 0 only."""
        path = os.path.join(self.root, name + (".tar" if with_opt else ".pth"))
        if not self.main:
            return path
        payload = self._to_file()
        if with_opt:
            payload = {
                "epoch": self.epochs_done,
                "model_state_dict": payload,
                "optimizer_state_dict": self._moments_to_file(
                    _portable(self.optimizer.state_dict())),
                "best": dict(self.best),
            }
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def load_checkpoint(self, path: str, with_opt: bool = False):
        """A ``.pth`` state_dict or a ``.tar`` checkpoint; ``with_opt`` also
        restores the optimizer, the epoch counter and the best metrics (a
        ``.tar`` only).  The optimizer keeps how it runs (``ADAM_RUN_KEYS``,
        the lr's kind), and as its state tensors are new ones, every
        captured step graph is dropped."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        is_tar = isinstance(blob, dict) and "model_state_dict" in blob
        self._load_file_state(blob["model_state_dict"] if is_tar else blob)
        if not with_opt:
            return
        if not is_tar:
            raise ValueError(f"{path} holds no optimizer state (not a checkpoint.tar)")
        names = self._param_names()
        opt = self._moments_from_file(blob["optimizer_state_dict"])
        params = dict(self.model.named_parameters())
        for idx, st in opt["state"].items():
            p = params[names[int(idx)]]
            for m in MOMENTS:
                if m in st and st[m].shape != p.shape:
                    raise ValueError(f"{path}: {m} of {names[int(idx)]} has shape "
                                     f"{tuple(st[m].shape)}, the parameter {tuple(p.shape)}")
        groups = []
        for saved, own in zip(opt["param_groups"], self.optimizer.param_groups):
            group = {**saved, **{k: own[k] for k in ADAM_RUN_KEYS if k in own}}
            if isinstance(own["lr"], torch.Tensor):
                group["lr"] = torch.tensor(float(saved["lr"]), device=own["lr"].device)
            groups.append(group)
        self.optimizer.load_state_dict({**opt, "param_groups": groups})
        if self.graphs is not None:
            self.graphs.reset()
        self.epochs_done = int(blob.get("epoch", 0))
        for k, v in (blob.get("best") or {}).items():
            self.best[k] = int(v) if k == "epoch" else float(v)

    def load_pretrained_modules(self, path: str, modules: Sequence[str] = PRETRAINED_MODULES):
        """Partial warm start: the weights of the top-level submodules
        ``modules`` that the file holds; the rest stay as they are
        (reference ``use_pretrained``, ``scripts/train.py:83-96``, which
        copies the four of ``PRETRAINED_MODULES``)."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = from_reference(blob.get("model_state_dict", blob))
        current = self.model.state_dict()
        current.update({k: v for k, v in sd.items() if k.split(".", 1)[0] in modules})
        self.model.load_state_dict(current)

    def profile_steps(self, loader, out_dir: str, num_steps: int = 3) -> str:
        """A ``torch.profiler`` trace (CPU and, on a card, CUDA activity) over
        a few train steps after one warm-up step, each step as the solver
        runs it (a graph's replay, or eagerly); returns the trace's path.
        A batch whose language grid the warm-up did not see is captured
        inside the trace."""
        from torch.profiler import ProfilerActivity, profile

        def step(ready):
            with ready as staged:
                dd = self._load(staged, "train")
            if self.graphs is not None:
                return self.graphs.train_step(dd)[0]
            return self._eager_train_step(dd, 0.1)

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with DevicePrefetcher(loader, self.spec, self.device) as batches:
            it = iter(batches)
            step(next(it))
            with profile(activities=activities) as prof:
                for _, ready in zip(range(num_steps), it):
                    metrics_to_host(step(ready))
        path = os.path.join(out_dir, "trace.json")
        if self.main:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        self._log(f"profiler trace written to {path}")
        return path

    def _finish(self, epoch_id):
        self._best_report()
        self._log("saving checkpoint...\n")
        self.save_checkpoint("checkpoint", with_opt=True)
        self._log("saving last models...\n")
        self.save_checkpoint("model_last")
        # tensorboard json export (lib/solver.py:389-391)
        for phase, w in self._log_writer.items():
            w.export_scalars_to_json(
                os.path.join(self.root, "tensorboard", phase, "all_scalars.json")
            )
            w.close()

    # ----------------------------------------------------------------- logging
    def init_log(self):
        self.log = {
            phase: {
                "forward": [], "backward": [], "eval": [], "fetch": [], "fetch_load": [],
                "fetch_copy": [], "fetch_stage": [], "iter_time": [],
                **{k: [] for k in self.metric_keys},
                "iou25_hits": 0.0, "iou5_hits": 0.0, "iou_count": 0.0,
                "iou_rate_0.25": 0.0, "iou_rate_0.5": 0.0,
            }
            for phase in ["train", "val"]
        }

    def _log(self, msg: str):
        if not self.main:
            return
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        print(msg, flush=True)

    def _dump_log(self, phase):
        if not self.main:
            return
        rec = {"iter": self._global_iter_id, "phase": phase}
        for key in METRIC_KEYS:
            vals = self.log[phase][key]
            rec[key] = float(np.mean(vals)) if vals else 0.0
        rec["iou_rate_0.25"] = self.log[phase]["iou_rate_0.25"]
        rec["iou_rate_0.5"] = self.log[phase]["iou_rate_0.5"]
        if phase == "train":
            # the lr Adam applies: a card's is a float32 tensor
            rec["lr"] = float(self.optimizer.param_groups[0]["lr"])
        with open(self.scalars_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if phase in self._log_writer:
            w = self._log_writer[phase]
            groups = {"loss": ["loss", "ref_loss", "lang_loss", "seg_loss"],
                      "score": ["lang_acc", "ref_acc", "seg_acc"]}
            for g, keys in groups.items():
                for k in keys:
                    w.add_scalar(f"{g}/{k}", rec[k], self._global_iter_id)
            w.add_scalar("score/iou_rate_0.25", rec["iou_rate_0.25"], self._global_iter_id)
            w.add_scalar("score/iou_rate_0.5", rec["iou_rate_0.5"], self._global_iter_id)

    def _train_report(self, epoch_id):
        log = self.log["train"]
        mean_train_time = float(np.mean(log["iter_time"]))
        mean_est_val_time = float(np.mean([f + fw for f, fw in zip(log["fetch"], log["forward"])]))
        remaining_iters = self._total_iter["train"] - self._global_iter_id - 1
        eta_sec = remaining_iters * mean_train_time
        # the val term counts only the validating epochs still ahead
        cur_epoch = self._global_iter_id // self._iters_per_epoch
        remaining_vals = max(self.epoch - max(cur_epoch, max(self.start_val - 1, 0)), 0)
        eta_sec += self._val_len * remaining_vals * mean_est_val_time
        eta = decode_eta(eta_sec)
        self._log(
            ITER_REPORT_TEMPLATE.format(
                epoch_id=epoch_id + 1,
                iter_id=self._global_iter_id + 1,
                total_iter=self._total_iter["train"],
                train_loss=round(float(np.mean(log["loss"])), 5),
                train_ref_loss=round(float(np.mean(log["ref_loss"])), 5),
                train_lang_loss=round(float(np.mean(log["lang_loss"])), 5),
                train_seg_loss=round(float(np.mean(log["seg_loss"])), 5),
                train_lang_acc=round(float(np.mean(log["lang_acc"])), 5),
                train_ref_acc=round(float(np.mean(log["ref_acc"])), 5),
                train_seg_acc=round(float(np.mean(log["seg_acc"])), 5),
                train_iou_rate_25=round(log["iou_rate_0.25"], 5),
                train_iou_rate_5=round(log["iou_rate_0.5"], 5),
                mean_fetch_time=round(float(np.mean(log["fetch"])), 5),
                mean_forward_time=round(float(np.mean(log["forward"])), 5),
                mean_backward_time=round(float(np.mean(log["backward"])), 5),
                mean_eval_time=round(float(np.mean(log["eval"])), 5),
                mean_iter_time=round(mean_train_time, 5),
                eta_h=eta["h"], eta_m=eta["m"], eta_s=eta["s"],
            )
        )
        self._log(FETCH_SPLIT_TEMPLATE.format(
            mean_load_time=round(float(np.mean(log["fetch_load"])), 5),
            mean_copy_time=round(float(np.mean(log["fetch_copy"])), 5),
            mean_stage_time=round(float(np.mean(log["fetch_stage"])), 5),
            phase_times=self._phase_times(),
        ))

    def _phase_times(self) -> str:
        """Where the iter report's forward, backward and eval times come from."""
        if self.graphs is not None:
            return ("the marks inside the step graphs, which each replay records (a key's "
                    "first step: its eager warm-up's)")
        return ("CUDA events" if self.device.type == "cuda" else "the host clock") + \
            " at the eager step's phase bounds"

    def _epoch_report(self, epoch_id):
        self._log(f"epoch [{epoch_id + 1}/{self.epoch}] done...")
        log = self.log["val"]
        self._log(
            EPOCH_REPORT_TEMPLATE.format(
                val_loss=round(float(np.mean(log["loss"])), 5),
                val_lang_loss=round(float(np.mean(log["lang_loss"])), 5),
                val_lang_acc=round(float(np.mean(log["lang_acc"])), 5),
                val_seg_acc=round(float(np.mean(log["seg_acc"])), 5),
                val_ref_acc=round(float(np.mean(log["ref_acc"])), 5),
                val_iou_rate_25=round(log["iou_rate_0.25"], 5),
                val_iou_rate_5=round(log["iou_rate_0.5"], 5),
            )
        )

    def _best_report(self):
        self._log("training completed...")
        report = BEST_REPORT_TEMPLATE.format(
            epoch=self.best["epoch"],
            loss=round(self.best["loss"], 5),
            ref_loss=round(self.best["ref_loss"], 5),
            lang_loss=round(self.best["lang_loss"], 5),
            lang_acc=round(self.best["lang_acc"], 5),
            ref_acc=round(self.best["ref_acc"], 5),
            iou_rate_25=round(self.best["iou_rate_0.25"], 5),
            iou_rate_5=round(self.best["iou_rate_0.5"], 5),
        )
        self._log(report)
        if self.main:
            with open(os.path.join(self.root, "best.txt"), "w") as f:
                f.write(report)
