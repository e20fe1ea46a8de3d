"""The train step and its schedules, counterpart of the step of
``instancerefer_tpu/train/solver.py`` (``make_optimizer`` :121-134,
``bn_momentum_for_epoch`` :137-150, ``train_step`` :250-268, ``_metrics``
:270-285).  The epoch loop, reports and checkpoints are not ported yet.

* ``make_optimizer``: ``torch.optim.Adam`` with L2 weight decay folded into
  the gradient — the optax chain ``add_decayed_weights -> scale_by_adam ->
  lr`` of the JAX package, with the same defaults (betas 0.9/0.999, eps 1e-8).
* ``make_scheduler``: ``MultiStepLR`` over epochs; step it once per epoch.
* ``bn_momentum_for_epoch``: the reference's BNMomentumScheduler.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss

METRIC_KEYS = ("loss", "ref_loss", "lang_loss", "seg_loss", "lang_acc", "ref_acc", "seg_acc")


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, wd: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, weight_decay=wd)


def make_scheduler(optimizer: torch.optim.Optimizer, lr_decay_step: Optional[Sequence[int]],
                   lr_decay_rate: Optional[float]) -> torch.optim.lr_scheduler.MultiStepLR:
    """lr x rate at each milestone epoch; constant without both."""
    if lr_decay_step and lr_decay_rate:
        steps = lr_decay_step if isinstance(lr_decay_step, (list, tuple)) else [lr_decay_step]
        return torch.optim.lr_scheduler.MultiStepLR(optimizer, [int(e) for e in steps],
                                                    float(lr_decay_rate))
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, [], 1.0)


def bn_momentum_for_epoch(epoch: int, bn_decay_step, bn_decay_rate) -> float:
    """max(0.5 * rate^(epoch // step), 0.001); 0.1 without a schedule."""
    if not (bn_decay_step and bn_decay_rate):
        return 0.1
    return max(0.5 * bn_decay_rate ** (epoch // bn_decay_step), 0.001)


def train_metrics(out: dict) -> Dict[str, torch.Tensor]:
    """Scalar metrics of one step: masked means, and the Acc@IoU hit and
    valid counts that the epoch pools."""
    metrics = {k: out[k].detach() for k in METRIC_KEYS if k != "ref_acc"}
    metrics["ref_acc"] = out["ref_acc_mean"].detach()
    valid, iou = out["sample_valid"], out["ref_iou"].detach()
    metrics["iou25_hits"] = ((iou >= 0.25) & valid).sum()
    metrics["iou5_hits"] = ((iou >= 0.5) & valid).sum()
    metrics["iou_count"] = valid.sum()
    return metrics


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, dd: dict,
               mean_size: torch.Tensor, bn_momentum: float = 0.1
               ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Train-mode forward -> ``get_loss`` -> backward -> ``optimizer.step()``
    -> ``get_eval``.  Returns (metrics, the step's outputs).  The gradients
    stay in ``.grad`` until the next step."""
    model.train()
    model.set_bn_momentum(bn_momentum)
    optimizer.zero_grad(set_to_none=True)
    out = get_loss(model(dd), mean_size)
    out["loss"].backward()
    optimizer.step()
    with torch.no_grad():
        out = get_eval(out)
    return train_metrics(out), out
