"""PointGroup's train and eval steps, their step-graph task and their
solver: ``models/pointgroup.PointGroup`` through the same entry points as
InstanceRefer (``Config`` -> model -> ``Solver`` -> ``StepGraphs``).

* ``train_body``: forward -> ``models/pointgroup.loss`` -> backward ->
  Adam -> the step's metrics; ``eval_body``: forward -> loss -> metrics.
  Neither reads a value back to the host, so both are captured as graphs.
* ``PointGroupTask``: the parts ``train/step_graph.StepGraphs`` takes from a
  model: one graph per phase (a batch's every shape is fixed by its
  ``data/pointgroup.PGSpec``), ``PGSpec.finish`` loads a batch.
* ``PointGroupSolver``: ``train/solver.Solver`` with PointGroup's metrics,
  reports and plain state dicts in its checkpoints; the best model is the
  one of the lowest val loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from instancerefer_tpu_torch.models import pointgroup as pg
from instancerefer_tpu_torch.train.solver import Solver
from instancerefer_tpu_torch.utils.profiling import span

METRIC_KEYS = ("loss", "semantic_loss", "offset_norm_loss", "offset_dir_loss", "semantic_acc")
OUT_KEYS = ("loss", "semantic_scores", "pt_offsets")

ITER_REPORT = """
-------------------------------iter: [{epoch}: {it}/{total}]-------------------------------
[loss] train_loss: {loss}
[loss] train_semantic_loss: {semantic_loss}
[loss] train_offset_norm_loss: {offset_norm_loss}
[loss] train_offset_dir_loss: {offset_dir_loss}
[sco.] train_semantic_acc: {semantic_acc}
[info] mean_fetch_time: {fetch}s
[info] mean_forward_time: {forward}s
[info] mean_backward_time: {backward}s
[info] mean_iter_time: {iter}s
"""


def _metrics(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: out[k].detach() for k in METRIC_KEYS}


def train_body(model: torch.nn.Module, optimizer: torch.optim.Optimizer, dd: dict,
               mark: Optional[Callable[[], None]] = None, set_to_none: bool = True):
    """One train step in the model's current mode: (metrics, outputs).
    ``mark`` is called at the bounds of forward (with the loss), backward
    (with Adam) and the metrics, as InstanceRefer's ``train_body`` calls it."""
    mark = mark or (lambda: None)
    with span("ir.adam"):
        optimizer.zero_grad(set_to_none=set_to_none)
    mark()
    out = model(dd)
    with span("ir.loss"):
        out.update(pg.loss(out, dd))
    mark()
    with span("ir.backward"):
        out["loss"].backward()
    with span("ir.adam"):
        optimizer.step()
    mark()
    with torch.no_grad(), span("ir.eval"):
        metrics = _metrics(out)
    mark()
    return metrics, out


def eval_body(model: torch.nn.Module, dd: dict, mark: Optional[Callable[[], None]] = None):
    """One eval step in the model's current mode: (metrics, outputs)."""
    mark = mark or (lambda: None)
    with torch.no_grad():
        mark()
        out = model(dd)
        with span("ir.loss"):
            out.update(pg.loss(out, dd))
        mark()
        with span("ir.eval"):
            metrics = _metrics(out)
        mark()
        return metrics, out


class PointGroupTask:
    """PointGroup's parts of a ``StepGraphs``: one graph a phase."""

    out_keys = OUT_KEYS

    @staticmethod
    def key(batch: Dict[str, torch.Tensor]) -> int:
        return 0

    @staticmethod
    def finish(staged, spec, out=None):
        return spec.finish(staged, out)

    @staticmethod
    def train_body(model, optimizer, dd, mean_size, mark, set_to_none=True):
        return train_body(model, optimizer, dd, mark, set_to_none)

    @staticmethod
    def eval_body(model, dd, mean_size, mark):
        return eval_body(model, dd, mark)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, dd: dict,
               bn_momentum: float = 0.1, timer=None):
    """``train_body`` eagerly, in train mode at ``bn_momentum``."""
    model.train()
    getattr(model, "module", model).set_bn_momentum(bn_momentum)
    return train_body(model, optimizer, dd, timer.mark if timer is not None else None)


class PointGroupSolver(Solver):
    """``Solver`` over PointGroup's batches (a ``data/pointgroup.PGSpec``)."""

    metric_keys = METRIC_KEYS
    best_key = "loss"
    best_higher = False

    def __init__(self, model, spec, device, **kw):
        super().__init__(model, np.zeros((1, 3)), spec, device, task=PointGroupTask(), **kw)

    def _initial_best(self) -> dict:
        return {"epoch": 0, **{k: float("inf") if "loss" in k else -float("inf")
                               for k in METRIC_KEYS}}

    def _eager_train_step(self, dd, bn_momentum):
        return train_step(self.train_model, self.optimizer, dd, bn_momentum, self.timer)[0]

    def _eval_step(self, dd):
        self.model.eval()
        return eval_body(self.model, dd, self.timer.mark)[0]

    def _accumulate(self, phase, metrics):
        for k in METRIC_KEYS:
            self.log[phase][k].append(metrics[k])

    def _pooled(self, phase):
        return {}

    def _to_file(self):
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    def _load_file_state(self, state):
        self.model.load_state_dict(state)

    def _moments_to_file(self, opt_state):
        return opt_state

    def _moments_from_file(self, opt_state):
        return opt_state

    def _means(self, phase) -> Dict[str, float]:
        log = self.log[phase]
        return {k: round(float(np.mean(log[k])), 5) if log[k] else 0.0 for k in METRIC_KEYS}

    def _dump_log(self, phase):
        if not self.main:
            return
        import json

        rec = {"iter": self._global_iter_id, "phase": phase, **self._means(phase)}
        if phase == "train":
            rec["lr"] = float(self.optimizer.param_groups[0]["lr"])
        with open(self.scalars_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _train_report(self, epoch_id):
        log = self.log["train"]
        self._log(ITER_REPORT.format(
            epoch=epoch_id + 1, it=self._global_iter_id + 1, total=self._total_iter["train"],
            fetch=round(float(np.mean(log["fetch"])), 5),
            forward=round(float(np.mean(log["forward"])), 5),
            backward=round(float(np.mean(log["backward"])), 5),
            iter=round(float(np.mean(log["iter_time"])), 5), **self._means("train")))

    def _epoch_report(self, epoch_id):
        self._log(f"epoch [{epoch_id + 1}/{self.epoch}] done...")
        self._log("[val] " + ", ".join(f"val_{k}: {v}" for k, v in self._means("val").items()))

    def _best_report(self):
        self._log("training completed...")
        report = "[best] " + ", ".join(f"{k}: {v}" for k, v in self.best.items()) + "\n"
        self._log(report)
        if self.main:
            import os

            with open(os.path.join(self.root, "best.txt"), "w") as f:
                f.write(report)
