"""The reference's train steps and eval forward over prepared batches
(``batch.prepare``), from a state dict: plain autograd and
``torch.optim.Adam`` in float32, with TF32 off (``no_tf32``).
``step_from`` takes one step from a train state taken whole
(``snapshot``): how the check follows the program's graph replays, one
step at a time from the state each started from.

``precision`` rounds the sparse convs (``model.precision_of``: the
control).  ``fault`` plants one of the faults a run's check has to catch,
so that the reference, put in the program's place, shows what each reads:
``"frozen"`` (the step returns its state unchanged), ``"half"`` (half of
the batch left out, the mean taken over the rest), ``"altered"`` (one
answer altered where it is produced: sample 0's first candidate's score
+1)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from benchmark.reference.batch import feature_dim
from benchmark.reference.loss import loss_and_eval
from benchmark.reference.model import InstanceRefer, forward, precision_of

FAULTS = ("frozen", "half", "altered")


def _model(state: Dict[str, torch.Tensor], cin: int, num_classes: int) -> InstanceRefer:
    model = InstanceRefer(cin, num_classes).to(next(iter(state.values())).device)
    model.load_state_dict(state)
    return model


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (not TF32) inside; the process's
    settings, which the program runs under, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _scores(model, d, ctx, mean_size, fault):
    out = forward(model, d, ctx)
    if fault == "altered":
        bump = torch.zeros_like(out["attribute_scores"])
        bump[0, 0] = 1.0
        out["attribute_scores"] = out["attribute_scores"] + bump
    valid = None
    if fault == "half":
        b = d["cand_mask"].shape[0]
        valid = torch.arange(b, device=d["cand_mask"].device) < b // 2
    return loss_and_eval(out, d, mean_size, valid)


def _one_step(model, opt, d, ctx, mean_size, fault, wd: float):
    """One train step: (its loss, the gradient as Adam takes it, weight
    decay added)."""
    opt.zero_grad(set_to_none=True)
    res = _scores(model, d, ctx, mean_size, fault)
    res["loss"].backward()
    grad = {n: (p.grad + wd * p).detach().clone() for n, p in model.named_parameters()}
    if fault != "frozen":
        opt.step()
    return float(res["loss"].detach()), grad


def _adam(model, cfg: dict) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg["lr"], weight_decay=cfg["wd"],
                            foreach=False)


def _ctx(cfg: dict, momentum: float, precision: Optional[str]) -> dict:
    return {"train": True, "momentum": momentum, "k": cfg["k"], "q": precision_of(precision)}


@no_tf32()
def train(state, batches: List[dict], cfg: dict, mean_size: torch.Tensor, momentum: float,
          precision: Optional[str] = None, fault: Optional[str] = None,
          keep: bool = False) -> dict:
    """One train step a batch from ``state``: each step's loss, the first
    step's gradient as Adam takes it (weight decay added), the BatchNorms'
    running means and variances after the first step (``stats1``), and the
    state after the last (parameters, ``stats``; with ``keep`` the whole
    state, Adam's with it, as ``snapshot``)."""
    model = _model(state, feature_dim(cfg), cfg["num_classes"])
    opt = _adam(model, cfg)
    ctx = _ctx(cfg, momentum, precision)
    losses, first_grad = [], None
    for i, d in enumerate(batches):
        loss, grad = _one_step(model, opt, d, ctx, mean_size, fault, cfg["wd"])
        losses.append(loss)
        if i == 0:
            first_grad, stats1 = grad, _stats(model)
    out = {"losses": losses, "first_grad": first_grad,
           "params": {n: p.detach().clone() for n, p in model.named_parameters()},
           "stats": _stats(model), "stats1": stats1}
    if keep:
        out["snapshot"] = snapshot(model, opt)
    return out


def snapshot(model, opt) -> dict:
    """A train state taken whole, on the host: ``state`` (the model's state
    dict) and ``adam`` (by parameter name: ``step``, ``exp_avg``,
    ``exp_avg_sq``; a parameter Adam has not stepped has none)."""
    host = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    adam = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            adam[n] = {"step": float(st["step"]),
                       "exp_avg": st["exp_avg"].detach().to("cpu", copy=True),
                       "exp_avg_sq": st["exp_avg_sq"].detach().to("cpu", copy=True)}
    return {"state": host, "adam": adam}


@no_tf32()
def step_from(snap: dict, batch: dict, cfg: dict, mean_size: torch.Tensor, momentum: float,
              precision: Optional[str] = None, fault: Optional[str] = None,
              keep: bool = False) -> dict:
    """One train step of ``batch`` from a state taken whole (``snapshot``):
    its loss, the gradient as Adam took it (weight decay added), and the
    parameters and running statistics after it, on the host (with
    ``keep``, the state after it, whole, as ``snapshot``)."""
    dev = mean_size.device
    model = _model({k: v.to(dev) for k, v in snap["state"].items()}, feature_dim(cfg),
                   cfg["num_classes"])
    opt = _adam(model, cfg)
    for n, p in model.named_parameters():
        if n in snap["adam"]:
            a = snap["adam"][n]
            opt.state[p] = {"step": torch.tensor(a["step"], dtype=torch.float32),
                            "exp_avg": a["exp_avg"].to(dev, copy=True),
                            "exp_avg_sq": a["exp_avg_sq"].to(dev, copy=True)}
    ctx = _ctx(cfg, momentum, precision)
    loss, grad = _one_step(model, opt, batch, ctx, mean_size, fault, cfg["wd"])
    out = {"loss": loss, "grad": {n: g.cpu() for n, g in grad.items()},
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
           "stats": {n: b.cpu() for n, b in _stats(model).items()}}
    if keep:
        out["snapshot"] = snapshot(model, opt)
    return out


def _stats(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}


@no_tf32()
@torch.no_grad()
def with_batch_statistics(state, batch: dict, cfg: dict) -> Dict[str, torch.Tensor]:
    """``state`` with every BatchNorm's running statistics set to those of
    one train-mode forward over ``batch`` (momentum 1): what a trained
    model holds, so that an eval forward's activations keep their scale
    (with the statistics at their start, 0 and 1, the encoders' outputs
    shrink layer by layer until the heads' biases drown them)."""
    model = _model(state, feature_dim(cfg), cfg["num_classes"])
    forward(model, batch, {"train": True, "momentum": 1.0, "k": cfg["k"],
                           "q": precision_of(None)})
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@no_tf32()
@torch.no_grad()
def evaluate(state, batch: dict, cfg: dict, mean_size: torch.Tensor,
             precision: Optional[str] = None, fault: Optional[str] = None) -> dict:
    """The eval forward of one batch: its loss and each candidate's score."""
    model = _model(state, feature_dim(cfg), cfg["num_classes"])
    ctx = {"train": False, "momentum": 0.0, "k": cfg["k"], "q": precision_of(precision)}
    res = _scores(model, batch, ctx, mean_size, fault)
    return {"loss": float(res["loss"]), "score": res["score"]}
