"""The train step and the eval step as CUDA graphs, counterpart of the JAX
package's jitted steps (``instancerefer_tpu/train/solver.py:250-293``: one
XLA program per step, compiled again for each language-grid bucket).

* ``train_body``: forward -> ``get_loss`` -> backward -> Adam -> ``get_eval``
  -> ``train_metrics`` (a graph's zeroes the gradients in place); ``eval_body``:
  forward -> ``get_loss`` -> ``get_eval`` -> ``train_metrics``.  Neither
  reads a value back to the host or makes a shape from the data, so both
  can be captured.  ``solver.train_step`` runs ``train_body`` eagerly.
* ``StepGraphs``: one graph per key (``"train"`` or ``"eval"``, the batch's
  language grid T, the compute dtype); under the caps every other shape is
  fixed.  A key's first batch runs its body eagerly on a side stream (the
  warm-up, which is also that batch's real step: every lazy set-up, such as
  a kernel's shared-memory limit and Adam's state, happens there); then the
  body is captured with ``torch.cuda.graph`` into a memory pool all the
  graphs share, and later batches of the key replay it.  Nothing falls back:
  a capture or a replay that fails raises.
* ``choose``: graphs or eager, decided in one place for the solver and the
  eval CLI: graphs on a card at world size 1, eager on the CPU and
  data-parallel.

A graph reads its inputs from static buffers: ``load`` ``finish``es a
staged batch (``data/host.stage``, on the card: ``data/prefetch``) straight
into the buffers of its key's graph, widening as it copies; a data dict from
elsewhere is copied into them (``data/host.copy_data``: the same names,
shapes and types, or it raises).  The step's outputs are
static too, so what a step returns is cloned: the metrics and ``OUT_KEYS``.
What Python does when a step runs is captured once: the compute dtype and
the model's settings are those of the capture (the dtype is part of the
key), the BN momentum is read from a buffer on the card
(``models/basic_blocks.MaskedBatchNorm``), Adam runs with
``capturable=True`` and a tensor lr (``solver.make_optimizer``), and dropout
draws new masks on every replay.  ``reset`` drops every graph: the solver
calls it when a checkpoint load swaps the optimizer's state tensors.
Nothing that holds an autograd graph of an eager step of the model may
be alive at a capture: each parameter's gradient accumulator lives as long
as a graph holds it and runs on the stream it was made on, so a capture
would reach the default stream and fail.

The model's own parts come from a ``task`` (``InstanceReferTask`` by
default; PointGroup's is ``train/pointgroup.PointGroupTask``): the key part
a batch gives (InstanceRefer: its language grid), the ``finish`` of its
staged batches, the train and eval bodies, and the outputs a step returns.

The kernel wrappers count their launches in Python, which a replay does not
run: the count a capture made is taken back and added on every replay
(``LAUNCH_COUNTERS``), so the counts read as they would eagerly.

A step's phases are timed inside it: the body's marks record CUDA events
(``StepMarks``), captured into the graph as nodes that every replay records
again, so ``phase_seconds`` reads a replay's own forward, backward and eval.
The host step path runs under the spans of ``utils/profiling`` (``ir.load``,
``ir.step`` and their children), which cost one check each while no
profiler records.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from instancerefer_tpu_torch.data.host import clone_data, copy_data, finish
from instancerefer_tpu_torch.ops import conv_bwd
from instancerefer_tpu_torch.ops.gather_conv import gather_conv
from instancerefer_tpu_torch.ops.masked_bn import masked_bn
from instancerefer_tpu_torch.ops.precision import get_compute_dtype
from instancerefer_tpu_torch.ops.up_conv import up_conv
from instancerefer_tpu_torch.parallel.distributed import all_reduce_sum, world_size
from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss
from instancerefer_tpu_torch.utils.profiling import span

METRIC_KEYS = ("loss", "ref_loss", "lang_loss", "seg_loss", "lang_acc", "ref_acc", "seg_acc")
# what a step returns besides its metrics: the losses, the scores and the
# per-sample eval results
OUT_KEYS = ("loss", "ref_loss", "lang_loss", "seg_loss", "seg_acc", "lang_acc", "ref_acc_mean",
            "num_missed", "lang_scores", "attribute_scores", "relation_scores", "scene_scores",
            "seg_scores", "score_mask", "cand_mask", "sample_valid", "ref_iou", "ref_acc",
            "lang_correct", "ref_multiple_mask", "ref_others_mask", "pred_bboxes", "gt_bboxes")
# (wrapper, attribute) of every launch counter of the hand-written kernels:
# the sparse convs', the fused masked BN's forward and backward calls, then
# the inverse convs' (their forward, dX and dW kernels)
LAUNCH_COUNTERS = ((gather_conv, "launches"), (gather_conv, "stem_launches"),
                   (conv_bwd.subm_conv_bwd, "launches"), (conv_bwd.conv_dw, "launches"),
                   (conv_bwd.conv_dw, "stem_launches"), (conv_bwd.dw_lists, "launches"),
                   (conv_bwd.down_dx, "launches"), (masked_bn, "launches"),
                   (masked_bn, "bwd_launches"), (up_conv, "launches"))

Step = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def train_metrics(out: dict) -> Dict[str, torch.Tensor]:
    """Scalar metrics of one step: masked means, and the Acc@IoU hit and
    valid counts that the epoch pools (summed over the ranks)."""
    metrics = {k: out[k].detach() for k in METRIC_KEYS if k != "ref_acc"}
    metrics["ref_acc"] = out["ref_acc_mean"].detach()
    valid, iou = out["sample_valid"], out["ref_iou"].detach()
    counts = {"iou25_hits": ((iou >= 0.25) & valid).sum(), "iou5_hits": ((iou >= 0.5) & valid).sum(),
              "iou_count": valid.sum()}
    if world_size() > 1:
        counts = dict(zip(counts, all_reduce_sum(torch.stack(list(counts.values())))))
    metrics.update(counts)
    return metrics


def train_body(model: torch.nn.Module, optimizer: torch.optim.Optimizer, dd: dict,
               mean_size: torch.Tensor, mark: Optional[Callable[[], None]] = None,
               set_to_none: bool = True) -> Step:
    """One train step in the model's current mode: (metrics, the step's
    outputs).  The gradients stay in ``.grad`` until the next step, which
    drops them (``set_to_none``) or zeroes them in place (a graph's: its
    backward accumulates into the tensors it captured).  ``mark`` is called
    at the bounds of forward (with the loss), backward (with Adam) and
    eval."""
    mark = mark or (lambda: None)
    with span("ir.adam"):
        optimizer.zero_grad(set_to_none=set_to_none)
    mark()
    out = model(dd)
    with span("ir.loss"):
        out = get_loss(out, mean_size)
    mark()
    with span("ir.backward"):
        out["loss"].backward()
    with span("ir.adam"):
        optimizer.step()
    mark()
    with torch.no_grad(), span("ir.eval"):
        out = get_eval(out)
        metrics = train_metrics(out)
    mark()
    return metrics, out


def eval_body(model: torch.nn.Module, dd: dict, mean_size: torch.Tensor,
              mark: Optional[Callable[[], None]] = None) -> Step:
    """One eval step in the model's current mode: (metrics, outputs).
    ``mark`` is called at the bounds of forward (with the loss) and eval."""
    mark = mark or (lambda: None)
    with torch.no_grad():
        mark()
        out = model(dd)
        with span("ir.loss"):
            out = get_loss(out, mean_size)
        mark()
        with span("ir.eval"):
            out = get_eval(out)
            metrics = train_metrics(out)
        mark()
        return metrics, out


class InstanceReferTask:
    """InstanceRefer's parts of a step graph: the language grid T keys a
    graph, ``data/host.finish`` loads a batch, ``train_body`` and
    ``eval_body`` run it, ``OUT_KEYS`` are returned."""

    out_keys = OUT_KEYS

    @staticmethod
    def key(batch: Dict[str, torch.Tensor]) -> int:
        return int(batch["lang_feat"].shape[1])

    @staticmethod
    def finish(staged, spec, out=None):
        return finish(staged, spec, out=out)

    @staticmethod
    def train_body(model, optimizer, dd, mean_size, mark, set_to_none=True) -> Step:
        return train_body(model, optimizer, dd, mean_size, mark, set_to_none)

    @staticmethod
    def eval_body(model, dd, mean_size, mark) -> Step:
        return eval_body(model, dd, mean_size, mark)


def launch_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS)


def _add_launch_counts(counts) -> None:
    for (fn, attr), n in zip(LAUNCH_COUNTERS, counts):
        setattr(fn, attr, getattr(fn, attr) + n)


def choose(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
           mean_size: torch.Tensor, task=None) -> Tuple[Optional["StepGraphs"], str]:
    """How the steps run, with the line that logs it: ``StepGraphs`` on a
    card at world size 1; ``None`` (eager) on the CPU, which has no graphs,
    and data-parallel, whose steps hold collectives (a graph cannot hold
    gloo's, and NCCL's across cards cannot be checked on one card)."""
    if mean_size.device.type != "cuda":
        return None, f"eager (on {mean_size.device})"
    if world_size() > 1:
        return None, f"eager (data-parallel over {world_size()} ranks)"
    return StepGraphs(model, optimizer, mean_size, task=task), (
        "CUDA graphs, one per (train or eval, batch key, compute dtype), captured after "
        "each key's first batch, which runs eagerly")


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` captured into the memory pool ``pool``."""

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None

    def capture(self, fn: Callable[[], Step]) -> Step:
        # the feed's thread (``data/prefetch``) stages, allocates and copies
        # on its own stream meanwhile; under the default "global" mode a
        # capture on this thread would refuse its calls
        with torch.cuda.graph(self.graph, pool=self.pool, capture_error_mode="thread_local"):
            self.outputs = fn()
        return self.outputs

    def replay(self) -> Step:
        self.graph.replay()
        return self.outputs


class StepMarks:
    """The times at the marks of a step's body (``train_body``'s and
    ``eval_body``'s ``mark``).  On a card each mark records a CUDA event
    with timing on the current stream; made ``external``, in a capture it
    becomes a node of the graph, which each replay records again (a replay
    runs no Python).  On the CPU each mark reads the host clock.  ``begin``
    forgets the last run's marks."""

    def __init__(self, device: torch.device, external: bool = False):
        self.device = device
        self.external = external
        self.marks: list = []

    def begin(self) -> None:
        self.marks = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True, external=self.external)
            event.record(torch.cuda.current_stream(self.device))
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        """Seconds between consecutive marks of the last run, which has
        ended (the step's results are on the host)."""
        if self.device.type == "cuda":
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


class _Captured:
    def __init__(self, graph, inputs: dict, launches: Tuple[int, ...], marks: StepMarks):
        self.graph = graph
        self.inputs = inputs
        self.launches = launches  # what the capture counted, added on each replay
        self.marks = marks  # the body's marks, recorded again by each replay


class StepGraphs:
    """The train and eval steps of ``model`` as graphs, one per key.

    ``mean_size`` is InstanceRefer's mean box sizes (any tensor on the
    steps' device for a task that reads none); ``task`` the model's parts
    (``InstanceReferTask`` by default).
    ``new_graph()`` makes the object a key's body is captured into and
    replayed from (``capture(fn) -> outputs``, ``replay() -> outputs``); the
    default is a ``CudaGraph`` in a pool the graphs share.  ``captures``
    counts the captures made, ``replays`` the replays, ``steps`` every step
    (a key's first step is its eager warm-up).  ``phase_seconds`` splits
    the last step at its body's marks."""

    def __init__(self, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
                 mean_size: torch.Tensor, new_graph: Optional[Callable[[], object]] = None,
                 task=None):
        self.model = model
        self.task = task or InstanceReferTask()
        self.optimizer = optimizer
        self.mean_size = mean_size
        self.device = mean_size.device
        if new_graph is None:
            pool = torch.cuda.graph_pool_handle()
            new_graph = lambda: CudaGraph(pool)  # noqa: E731
        self.new_graph = new_graph
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self.steps = 0
        self._fresh = None  # the last data dict ``load`` made for a key with no graph
        self._marks: Optional[StepMarks] = None  # the last step's

    @staticmethod
    def key(phase: str, lang_grid: int) -> tuple:
        """The graph of a step: ``phase`` (``"train"`` or ``"eval"``), the
        batch's key part (InstanceRefer's language grid T) and the compute
        dtype."""
        return phase, int(lang_grid), str(get_compute_dtype() or torch.float32)

    def load(self, staged: Dict[str, torch.Tensor], spec, phase: str) -> dict:
        """``finish`` of a staged batch on the card: into the static inputs
        of its key's graph if there is one (they are overwritten), else into
        new tensors that the key's capture takes as its inputs."""
        with span("ir.load", step=self.steps):
            step = self.graphs.get(self.key(phase, self.task.key(staged)))
            if step is not None:
                return self.task.finish(staged, spec, out=step.inputs)
            self._fresh = self.task.finish(staged, spec)
            return self._fresh

    def train_step(self, dd: dict, bn_momentum: float = 0.1) -> Step:
        """One train step of ``dd``: (metrics, ``OUT_KEYS`` of the outputs),
        both clones."""
        def mode():
            self.model.train()
            self.model.set_bn_momentum(bn_momentum)

        return self._step("train", dd, mode, lambda d, mark: self.task.train_body(
            self.model, self.optimizer, d, self.mean_size, mark, set_to_none=False))

    def eval_step(self, dd: dict) -> Step:
        """One eval step of ``dd``: (metrics, ``OUT_KEYS`` of the outputs),
        both clones."""
        return self._step("eval", dd, self.model.eval,
                          lambda d, mark: self.task.eval_body(self.model, d, self.mean_size, mark))

    def phase_seconds(self) -> List[float]:
        """The last step's seconds between its body's marks (train:
        forward with the loss, backward with Adam, eval; eval: forward with
        the loss, eval), read once its results are on the host: a replay's
        from the events its graph records, a warm-up's from its own."""
        return self._marks.seconds()

    def reset(self) -> None:
        """Drop every graph; the next batch of each key captures anew."""
        self.graphs.clear()
        self._fresh = None

    def _step(self, phase: str, dd: dict, mode: Callable[[], object],
              body: Callable[[dict, Callable[[], None]], Step]) -> Step:
        def run(d: dict, marks: StepMarks) -> Step:  # detached: no output holds the autograd graph
            marks.begin()
            metrics, out = body(d, marks.mark)
            return ({k: v.detach() for k, v in metrics.items()},
                    {k: out[k].detach() for k in self.task.out_keys if k in out})

        with span("ir.step", step=self.steps, phase=phase):
            self.steps += 1
            with span("ir.step.mode"):
                mode()
                key = self.key(phase, self.task.key(dd))
                step = self.graphs.get(key)
                if step is not None and dd is not step.inputs:
                    copy_data(dd, step.inputs)
            if step is None:
                with span("ir.step.capture"):
                    # a dict of the caller's own is copied, so a later batch
                    # of the key never writes into the caller's tensors
                    inputs = dd if dd is self._fresh else clone_data(dd)
                    self._fresh = None
                    self._marks = StepMarks(self.device)
                    result = self._warm_up(lambda: run(inputs, self._marks))
                    before = launch_counts()
                    graph = self.new_graph()
                    marks = StepMarks(self.device, external=True)
                    graph.capture(lambda: run(inputs, marks))
                    counted = tuple(a - b for a, b in zip(launch_counts(), before))
                    _add_launch_counts(-n for n in counted)  # nothing ran: a replay launches
                    self.graphs[key] = _Captured(graph, inputs, counted, marks)
                    self.captures += 1
            else:
                with span("ir.step.replay"):
                    result = step.graph.replay()
                    _add_launch_counts(step.launches)
                    self.replays += 1
                    self._marks = step.marks
            with span("ir.step.clone"):
                metrics, out = result
                return ({k: v.clone() for k, v in metrics.items()},
                        {k: v.clone() for k, v in out.items()})

    def _warm_up(self, run: Callable[[], Step]) -> Step:
        """The key's first step, eagerly; on a card on a side stream, as a
        capture wants its first launches made off the capturing stream."""
        if self.device.type != "cuda":
            return run()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = run()
        current.wait_stream(side)
        return result
