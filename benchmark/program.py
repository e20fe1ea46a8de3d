"""The benchmark's one door into the system under test, the PyTorch and
CUDA port ``instancerefer_tpu_torch``: its configuration, its host
pipeline (the batches it derives from the generated scenes), its model
with the benchmark's weights loaded, its optimizer, its step graphs and
its counters.  Every import of the program is inside a function, so the
harness's own modules load without it."""

from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch


def config(values: dict):
    """The program's ``Config`` with a configuration file's values on it
    (keys the program has no field for are the benchmark's own)."""
    from instancerefer_tpu_torch.config import Config

    cfg = Config()
    fields = {f.name for f in dataclasses.fields(Config)}
    for k, v in values.items():
        if k in fields:
            setattr(cfg, k, tuple(v) if isinstance(v, list) else v)
    return cfg


def _core(scene):
    from instancerefer_tpu_torch.data.pipeline import CoreSample

    return CoreSample(
        lang_feat=scene.lang_feat, lang_len=scene.lang_len, object_cat=scene.object_cat,
        point_cloud=scene.point_cloud, instance_points=scene.instance_points,
        instance_class=scene.instance_class, instance_obbs=scene.instance_obbs,
        ref_center_label=scene.ref_center_label, ref_size_class_label=scene.ref_size_class_label,
        ref_size_residual_label=scene.ref_size_residual_label,
        unique_multiple=scene.unique_multiple, object_id=0, ann_id=0, scan_idx=scene.scan_idx)


def batches(pool: List[list], cfg, threads: int) -> List[Dict[str, np.ndarray]]:
    """The program's padded batch of each list of scenes: ``pad_sample`` of
    every scene on ``threads`` host threads, then ``finalize_batch``."""
    from instancerefer_tpu_torch.data.pipeline import finalize_batch, pad_sample

    spec = cfg.batch_spec()

    def pad(scene):
        return pad_sample(_core(scene), spec, cfg.voxel_size_ap, cfg.voxel_size_glp)

    with ThreadPoolExecutor(threads) as ex:
        return [finalize_batch(list(ex.map(pad, scenes)), len(scenes), spec, pool=ex)
                for scenes in pool]


def stage(batch: Dict[str, np.ndarray], cfg, device) -> Dict[str, torch.Tensor]:
    """A padded batch staged on ``device``: what ``StepGraphs.load`` takes."""
    from instancerefer_tpu_torch.data.host import stage_to

    return stage_to(batch, cfg.batch_spec(), device)


@contextlib.contextmanager
def _no_range(name: str):
    yield


class EagerGraph:
    """Stands in for a CUDA graph where there is none (the CPU rehearsal):
    the capture keeps the body, a replay runs it."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        return self.fn()


@dataclasses.dataclass
class System:
    """The program as a user's training or eval run holds it."""

    cfg: object
    model: torch.nn.Module
    optimizer: object
    graphs: object
    mean_size: torch.Tensor
    momentum: float

    def step(self, staged: Dict[str, torch.Tensor], phase: str, ranges=None):
        """One step of a staged batch as the solver runs it: ``load`` into
        the graph's inputs, the step, the metrics to the host, each inside
        ``ranges(name)`` where given (the trace's host ranges).  Returns
        (the metrics on the host, the step's outputs)."""
        from instancerefer_tpu_torch.train.solver import metrics_to_host

        ranges = ranges or _no_range
        with ranges("load"):
            dd = self.graphs.load(staged, self.cfg.batch_spec(), phase)
        with ranges("step"):
            if phase == "train":
                metrics, out = self.graphs.train_step(dd, self.momentum)
            else:
                metrics, out = self.graphs.eval_step(dd)
        with ranges("metrics_to_host"):
            return metrics_to_host(metrics), out

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The gradient Adam took at its first step, from its state:
        exp_avg / (1 - beta1), by parameter name."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        state = self.optimizer.state
        return {n: (state[p]["exp_avg"] / (1 - beta1)).detach().clone() if "exp_avg" in state[p]
                else torch.zeros_like(p) for n, p in self.model.named_parameters()}

    def snapshot(self) -> dict:
        """The train state taken whole, on the host: ``state`` (the model's
        state dict) and ``adam`` (by parameter name: ``step``, ``exp_avg``,
        ``exp_avg_sq``), the form ``reference.steps.step_from`` starts from."""
        def host(t):
            return t.detach().to("cpu", copy=True)

        state = self.optimizer.state
        return {"state": {k: host(v) for k, v in self.model.state_dict().items()},
                "adam": {n: {"step": float(state[p]["step"]), "exp_avg": host(state[p]["exp_avg"]),
                             "exp_avg_sq": host(state[p]["exp_avg_sq"])}
                         for n, p in self.model.named_parameters() if state.get(p)}}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def stats(self) -> Dict[str, torch.Tensor]:
        return {n: b.detach().clone() for n, b in self.model.named_buffers() if "running" in n}


def system(cfg, state: Dict[str, torch.Tensor], mean_size: np.ndarray, phase: str,
           device, dropout: float) -> System:
    """The program's model with ``state`` loaded, every dropout at
    ``dropout``, in the configuration's compute type; in train its Adam;
    its step graphs (on the CPU, graphs that run eagerly)."""
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import bn_momentum_for_epoch, make_optimizer
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    set_compute_dtype(cfg.compute_dtype)
    model = InstanceRefer(cfg.input_feature_dim, cfg.num_classes, cfg.max_candidates,
                          use_bidir=cfg.use_bidir, k=cfg.k,
                          dropout_override=dropout).to(device)
    model.load_state_dict(state)
    optimizer = make_optimizer(model.parameters(), cfg.lr, cfg.wd) if phase == "train" else None
    ms = torch.tensor(mean_size, dtype=torch.float32, device=device)
    graphs = StepGraphs(model, optimizer, ms,
                        new_graph=None if ms.is_cuda else EagerGraph)
    return System(cfg, model, optimizer, graphs, ms,
                  bn_momentum_for_epoch(0, cfg.bn_decay_step, cfg.bn_decay_rate))


def build_kernels() -> None:
    """The program's CUDA kernels from its build directory inside the
    checkout (``instancerefer_tpu_torch/build/``), built there by the
    first run."""
    from instancerefer_tpu_torch.ops import gather_conv

    gather_conv.build()


def launch_counts():
    """The kernel wrappers' launch counters: (K1, K1 at the stems, K2, K3,
    K3 at the stems, K3's list pass, the downs' dX)."""
    from instancerefer_tpu_torch.train.step_graph import launch_counts as counts

    return counts()


def host_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))
