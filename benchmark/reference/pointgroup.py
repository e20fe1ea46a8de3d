"""PointGroup's first training phase in plain PyTorch, float32: the
reference the port's PointGroup is held against.  Written from the
published code (Jiang et al., "PointGroup: Dual-Set Point Grouping for 3D
Instance Segmentation", CVPR 2020; github.com/dvlab-research/PointGroup:
``model/pointgroup/pointgroup.py``, ``data/scannetv2_inst.py``,
``config/pointgroup_run1_scannet.yaml``) and importing nothing of the port
or of JAX.  Parameter names follow the published modules as the port names
them, so one state dict loads into both; a sparse conv's kernel is [K, Cin,
Cout] over the offsets below (x fastest), spconv's [k, k, k, Cin, Cout] in
another order.

* ``prepare``: scenes -> a batch: xyz about its mean, rgb / 127.5 - 1,
  nyu40 ids -> the 20 classes (others -100), instance ids (0 = none ->
  -100); xyz * scale shifted to its minimum and floored to voxels, each
  voxel the mean of its points' [rgb, xyz]; the levels' coordinates (level
  s the distinct floor(c / 2^s) of the level before) and their maps,
  computed here from the coordinates: ``nbr`` (the 27 offsets of a 3^3
  submanifold conv, o * 2^s), ``parent`` and ``child_k`` (the row of level
  s + 1 a row feeds, and at which of the 8 offsets), and ``down`` (a coarse
  row's 8 children); each point's voxel; the offset targets (its
  instance's mean xyz minus the point).
* ``PointGroup``: the U-Net (input conv, seven levels of widths m .. 7m,
  block_reps residual blocks, downs, inverse convs, tails) and the heads;
  ``forward`` in train or eval mode.  A sparse conv is a sum over its
  offsets of gathered rows times the offset's slice (a custom autograd
  Function each, so that ``q`` can round its inputs, outputs and
  cotangents: the control); an inverse conv is written from its
  definition, each fine row taking its parent's row times its offset's
  slice.
* ``loss``: cross entropy over the labelled points + the offsets' L1 and
  direction terms over the points of an instance.
* ``train_steps`` / ``step_from``: Adam steps with TF32 off.

Departures from the published code, each shared with the port:
* augmentation off (jitter, flip, rotation, elastic distortion), and no
  crop: every scene here has at most ``max_npoint`` points;
* Adam takes the yaml's weight_decay 1e-4 (the published ``train.py``
  passes it to SGD only);
* BatchNorm over voxels counts the batch's voxels alone (no padding), the
  biased variance normalizes and the unbiased one enters the running
  variance, momentum 0.1, eps 1e-4.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

SEM_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
IGNORE = -100
OFFSETS_3 = [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)]
OFFSETS_2 = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
_BITS = 16
F32 = lambda t: t  # noqa: E731  -- the reference's own precision: none lost


# --------------------------------------------------------------------- data
def _key(coords: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    c = coords.long() + (1 << (_BITS - 1))
    if c.numel() and (int(c.min()) < 0 or int(c.max()) >= 1 << _BITS):
        raise ValueError("voxel coordinates out of the key's range")
    return (((batch.long() << _BITS | c[:, 0]) << _BITS | c[:, 1]) << _BITS) | c[:, 2]


def _lookup(sorted_keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    if len(sorted_keys) == 0:
        return torch.full_like(query, -1)
    pos = torch.searchsorted(sorted_keys, query).clamp(max=len(sorted_keys) - 1)
    return torch.where(sorted_keys[pos] == query, pos, -1)


def prepare(scenes: Sequence[Dict[str, torch.Tensor]], scale: float, levels: int,
            device=None) -> dict:
    """A batch of ``scenes`` (each ``xyz`` [N, 3] metres, ``rgb`` [N, 3]
    0-255, ``sem`` [N] nyu40 ids, ``ins`` [N] instance ids, 0 = none),
    everything computed again from the arrays (see the module docstring), on
    ``device`` (default the CPU)."""
    dev = torch.device(device or "cpu")
    remap = torch.full((256,), IGNORE, dtype=torch.long, device=dev)
    remap[list(SEM_CLASS_IDS)] = torch.arange(len(SEM_CLASS_IDS), device=dev)
    coords, batch, feats, labels, valid, offsets, counts = [], [], [], [], [], [], []
    for b, sc in enumerate(scenes):
        xyz = torch.as_tensor(sc["xyz"], dtype=torch.float64).to(dev)
        xyz = (xyz - xyz.mean(0)).float().double()  # stored in float32, as the published data
        rgb = (torch.as_tensor(sc["rgb"]).to(dev, torch.float32) / 127.5 - 1.0).double()
        sem = remap[torch.as_tensor(sc["sem"]).to(dev, torch.long).clamp(0, 255)]
        ins = torch.as_tensor(sc["ins"]).to(dev, torch.long) - 1
        grid = xyz * scale
        coords.append(torch.floor(grid - grid.min(0).values).long())
        batch.append(torch.full((len(xyz),), b, dtype=torch.long, device=dev))
        feats.append(torch.cat([rgb, xyz], 1))
        labels.append(sem)
        has = ins >= 0
        n = max(int(ins.max()) + 1, 1) if len(ins) else 1
        num = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, ins[has], torch.ones(int(has.sum()), dtype=torch.float64, device=dev))
        centre = torch.zeros(n, 3, dtype=torch.float64, device=dev).index_add_(0, ins[has],
                                                                               xyz[has])
        centre = centre / num.clamp(min=1)[:, None]
        offsets.append(torch.where(has[:, None], centre[ins.clamp(min=0)] - xyz, 0.0))
        valid.append(has)
        counts.append(len(xyz))
    coords, batch = torch.cat(coords), torch.cat(batch)
    point_feats = torch.cat(feats)
    keys = _key(coords, batch)
    uniq, p2v = torch.unique(keys, return_inverse=True)
    n_vox = len(uniq)
    num = torch.zeros(n_vox, dtype=torch.float64, device=dev).index_add_(
        0, p2v, torch.ones(len(p2v), dtype=torch.float64, device=dev))
    vox_feats = torch.zeros(n_vox, 6, dtype=torch.float64, device=dev).index_add_(0, p2v,
                                                                                   point_feats)
    vox_feats = vox_feats / num[:, None]
    first = torch.full((n_vox,), len(keys), dtype=torch.long, device=dev).scatter_reduce(
        0, p2v, torch.arange(len(keys), device=dev), "amin")
    lv_coords, lv_batch = coords[first], batch[first]
    out_levels = []
    for s in range(levels):
        stride = 1 << s
        if s:
            prev = out_levels[-1]
            parent_c = torch.div(prev["coords"], 2 * (stride // 2), rounding_mode="floor") * stride
            pk = _key(parent_c, prev["batch"])
            uq, inv = torch.unique(pk, return_inverse=True)
            firstp = torch.full((len(uq),), len(pk), dtype=torch.long, device=dev).scatter_reduce(
                0, inv, torch.arange(len(pk), device=dev), "amin")
            lv_coords, lv_batch = parent_c[firstp], prev["batch"][firstp]
            rel = torch.div(prev["coords"] - parent_c, stride // 2, rounding_mode="floor")
            child_k = rel[:, 0] + 2 * rel[:, 1] + 4 * rel[:, 2]
            down = torch.full((len(uq), 8), -1, dtype=torch.long, device=dev)
            down[inv, child_k] = torch.arange(len(pk), device=dev)
            prev["parent"], prev["child_k"] = inv, child_k
        k = _key(lv_coords, lv_batch)
        nbr = torch.stack([_lookup(k, _key(lv_coords + torch.tensor(o, device=dev) * stride,
                                           lv_batch)) for o in OFFSETS_3], 1)
        out_levels.append({"coords": lv_coords, "batch": lv_batch, "nbr": nbr,
                           "down": down if s else None})
    return {
        "levels": out_levels, "feats": vox_feats.float(), "p2v": p2v,
        "sem_label": torch.cat(labels), "ins_valid": torch.cat(valid),
        "gt_offset": torch.cat(offsets).float(), "points": counts,
        "rows": [len(lv["coords"]) for lv in out_levels],
        "rows_per_scene": [[int((lv["batch"] == b).sum()) for lv in out_levels]
                           for b in range(len(scenes))],
    }


# -------------------------------------------------------------- sparse convs
def _gather_sum(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k x[nbr[:, k]] @ w[k], -1 reading a zero row."""
    table = torch.cat([x, x.new_zeros(1, x.shape[1])])
    safe = torch.where(nbr >= 0, nbr, x.shape[0])
    out = x.new_zeros(nbr.shape[0], w.shape[2])
    for k in range(nbr.shape[1]):
        out = out + table[safe[:, k]] @ w[k]
    return out


def _gather_dw(x: torch.Tensor, nbr: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    table = torch.cat([x, x.new_zeros(1, x.shape[1])])
    safe = torch.where(nbr >= 0, nbr, x.shape[0])
    return torch.stack([table[safe[:, k]].T @ g for k in range(nbr.shape[1])])


def _scatter_rows(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """out[index[i]] = rows[i] (each index at most once), other rows 0."""
    out = rows.new_zeros(n, rows.shape[1])
    return out.index_copy(0, index, rows)


class _Subm(torch.autograd.Function):
    """out[v] = sum_k x[nbr[v, k]] @ W[k]; the map is symmetric (offset 26
    - k mirrors k), so dX[u] = sum_k g[nbr[u, k]] @ W[26 - k]^T."""

    @staticmethod
    def forward(ctx, x, w, nbr, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq, nbr)
        ctx.q = q
        return q(_gather_sum(xq, nbr, wq))

    @staticmethod
    def backward(ctx, g):
        xq, wq, nbr = ctx.saved_tensors
        gq = ctx.q(g)
        dx = ctx.q(_gather_sum(gq, nbr, wq.flip(0).transpose(1, 2))) \
            if ctx.needs_input_grad[0] else None
        return dx, _gather_dw(xq, nbr, gq), None, None


class _Down(torch.autograd.Function):
    """out[v] = sum_k x[down[v, k]] @ W[k]; a fine row u feeds one coarse
    row parent[u] at one offset child_k[u]: dX[u] = g[parent[u]] @
    W[child_k[u]]^T."""

    @staticmethod
    def forward(ctx, x, w, down, parent, child_k, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq, down, parent, child_k)
        ctx.q = q
        return q(_gather_sum(xq, down, wq))

    @staticmethod
    def backward(ctx, g):
        xq, wq, down, parent, child_k = ctx.saved_tensors
        gq = ctx.q(g)
        dx = torch.zeros_like(xq)
        for k in range(8):
            rows = torch.nonzero(child_k == k)[:, 0]
            dx[rows] = gq[parent[rows]] @ wq[k].T
        return ctx.q(dx), _gather_dw(xq, down, gq), None, None, None, None


class _Inverse(torch.autograd.Function):
    """The inverse conv from its definition: out[u] = x[parent[u]] @
    W[child_k[u]] for every fine row u (each has a parent); dX[v] = sum over
    v's children u of g[u] @ W[child_k[u]]^T, dW[k] = sum over the rows u at
    offset k of x[parent[u]]^T g[u]."""

    @staticmethod
    def forward(ctx, x, w, parent, child_k, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq, parent, child_k)
        ctx.q = q
        out = xq.new_zeros(len(parent), wq.shape[2])
        for k in range(8):
            rows = torch.nonzero(child_k == k)[:, 0]
            out[rows] = xq[parent[rows]] @ wq[k]
        return q(out)

    @staticmethod
    def backward(ctx, g):
        xq, wq, parent, child_k = ctx.saved_tensors
        gq = ctx.q(g)
        dx = torch.zeros_like(xq)
        dw = torch.zeros_like(wq)
        for k in range(8):
            rows = torch.nonzero(child_k == k)[:, 0]
            dx = dx.index_add(0, parent[rows], gq[rows] @ wq[k].T)
            dw[k] = xq[parent[rows]].T @ gq[rows]
        return ctx.q(dx), dw, None, None, None


class _OneByOne(torch.autograd.Function):
    """The 1 x 1 submanifold conv of a residual block's identity branch."""

    @staticmethod
    def forward(ctx, x, w, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq)
        ctx.q = q
        return q(xq @ wq[0])

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.q(g)
        return ctx.q(gq @ wq[0].T), (xq.T @ gq)[None], None


# ------------------------------------------------------------------- model
class BN(nn.Module):
    """BatchNorm1d's parameters and running statistics; ``forward`` takes
    the mode and the momentum."""

    def __init__(self, c: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, train: bool, momentum: float):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            n = x.shape[0]
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            with torch.no_grad():
                self.running_mean.mul_(1 - momentum).add_(momentum * mean)
                self.running_var.mul_(1 - momentum).add_(momentum * var * n / max(n - 1, 1))
                self.num_batches_tracked += 1
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class Kernel(nn.Module):
    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))


class Res(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        if cin != cout:
            self.i_branch = nn.Sequential(Kernel(1, cin, cout))
        self.conv_branch = nn.Sequential(BN(cin, eps), nn.ReLU(), Kernel(27, cin, cout),
                                         BN(cout, eps), nn.ReLU(), Kernel(27, cout, cout))

    def forward(self, x, lv, ctx):
        bn1, _, k1, bn2, _, k2 = self.conv_branch
        h = torch.relu(bn1(x, ctx["train"], ctx["momentum"]))
        h = _Subm.apply(h, k1.kernel, lv["nbr"], ctx["q"])
        h = torch.relu(bn2(h, ctx["train"], ctx["momentum"]))
        h = _Subm.apply(h, k2.kernel, lv["nbr"], ctx["q"])
        i = _OneByOne.apply(x, self.i_branch[0].kernel, ctx["q"]) if hasattr(self, "i_branch") \
            else x
        return h + i


class UBlock(nn.Module):
    def __init__(self, planes: Sequence[int], reps: int, eps: float, level: int = 0):
        super().__init__()
        c = planes[0]
        self.level = level
        self.blocks = nn.ModuleDict({f"block{i}": Res(c, c, eps) for i in range(reps)})
        if len(planes) > 1:
            self.conv = nn.Sequential(BN(c, eps), nn.ReLU(), Kernel(8, c, planes[1]))
            self.u = UBlock(planes[1:], reps, eps, level + 1)
            self.deconv = nn.Sequential(BN(planes[1], eps), nn.ReLU(), Kernel(8, planes[1], c))
            self.blocks_tail = nn.ModuleDict({f"block{i}": Res(c * (2 - i), c, eps)
                                              for i in range(reps)})

    def forward(self, x, levels, ctx):
        lv = levels[self.level]
        for block in self.blocks.values():
            x = block(x, lv, ctx)
        if not hasattr(self, "u"):
            return x
        nxt = levels[self.level + 1]
        bn, _, k = self.conv
        d = torch.relu(bn(x, ctx["train"], ctx["momentum"]))
        d = _Down.apply(d, k.kernel, nxt["down"], lv["parent"], lv["child_k"], ctx["q"])
        d = self.u(d, levels, ctx)
        bn, _, k = self.deconv
        d = torch.relu(bn(d, ctx["train"], ctx["momentum"]))
        d = _Inverse.apply(d, k.kernel, lv["parent"], lv["child_k"], ctx["q"])
        x = torch.cat([x, d], 1)
        for block in self.blocks_tail.values():
            x = block(x, lv, ctx)
        return x


class PointGroup(nn.Module):
    def __init__(self, cin: int = 6, m: int = 16, levels: int = 7, reps: int = 2,
                 classes: int = 20, eps: float = 1e-4):
        super().__init__()
        self.input_conv = nn.Sequential(Kernel(27, cin, m))
        self.unet = UBlock([m * (i + 1) for i in range(levels)], reps, eps)
        self.output_layer = nn.Sequential(BN(m, eps), nn.ReLU())
        self.linear = nn.Linear(m, classes)
        self.offset = nn.Sequential(nn.Linear(m, m), BN(m, eps), nn.ReLU())
        self.offset_linear = nn.Linear(m, 3)

    def forward(self, d: dict, ctx: dict) -> Dict[str, torch.Tensor]:
        levels = d["levels"]
        x = _Subm.apply(d["feats"], self.input_conv[0].kernel, levels[0]["nbr"], ctx["q"])
        x = self.unet(x, levels, ctx)
        x = torch.relu(self.output_layer[0](x, ctx["train"], ctx["momentum"]))
        feats = x[d["p2v"]]
        h = self.offset[0](feats)
        h = torch.relu(self.offset[1](h, ctx["train"], ctx["momentum"]))
        return {"semantic_scores": self.linear(feats), "pt_offsets": self.offset_linear(h)}


def init_state(model: nn.Module, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """Weights from ``seed``: a sparse conv's kernel uniform within 1 /
    sqrt(K Cin) (spconv's kaiming uniform, a = sqrt(5)), a Linear's weight
    and bias within 1 / sqrt(fan-in) (torch's), BN weight 1 and bias 0,
    drawn on the CPU in the modules' order."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Kernel):
                k, cin, _ = mod.kernel.shape
                bound = 1.0 / math.sqrt(k * cin)
                mod.kernel.copy_(torch.rand(mod.kernel.shape, generator=gen) * 2 * bound - bound)
            elif isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    return {k: v.detach().clone().to(device or "cpu") for k, v in model.state_dict().items()}


def loss(out: Dict[str, torch.Tensor], d: dict) -> torch.Tensor:
    """CE over the labelled points + sum over the points of an instance of
    |pred - gt|_1 and of -cos(pred, gt), each / (their count + 1e-6)."""
    sem_loss = F.cross_entropy(out["semantic_scores"], d["sem_label"], ignore_index=IGNORE)
    valid = d["ins_valid"].float()
    gt, off = d["gt_offset"], out["pt_offsets"]
    count = valid.sum() + 1e-6
    norm_loss = ((off - gt).abs().sum(-1) * valid).sum() / count
    gt_dir = gt / (torch.norm(gt, p=2, dim=1, keepdim=True) + 1e-8)
    pt_dir = off / (torch.norm(off, p=2, dim=1, keepdim=True) + 1e-8)
    dir_loss = (-(gt_dir * pt_dir).sum(-1) * valid).sum() / count
    return sem_loss + norm_loss + dir_loss


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def precision_of(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of the sparse convs' inputs, outputs and cotangents:
    ``None`` for f32; ``"fp8"`` to float8 e4m3 under a per-tensor scale
    (its largest magnitude to 448), the control; ``"bf16"`` to bfloat16, the
    program's own storage (a witness of what that rounding alone moves)."""
    if name is None:
        return F32
    if name == "bf16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if name != "fp8":
        raise ValueError(f"no precision {name!r}")

    def fp8(t: torch.Tensor) -> torch.Tensor:
        amax = t.detach().abs().max()
        if not bool(amax > 0):
            return t
        s = 448.0 / amax
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return fp8


def _model(state: Dict[str, torch.Tensor], cfg: dict) -> PointGroup:
    model = PointGroup(6, cfg["m"], cfg["num_levels"], cfg["block_reps"], cfg["sem_classes"],
                       cfg["bn_eps"]).to(next(iter(state.values())).device)
    model.load_state_dict(state)
    return model


def _stats(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}


@no_tf32()
def forward_loss(state, d: dict, cfg: dict, train: bool = True, momentum: float = 0.1,
                 precision: Optional[str] = None) -> dict:
    """One forward and the loss (and, in train mode, its gradients and the
    running statistics after): ``loss``, ``grad`` by parameter, ``stats``,
    ``out``."""
    model = _model(state, cfg)
    ctx = {"train": train, "momentum": momentum, "q": precision_of(precision)}
    out = model(d, ctx)
    total = loss(out, d)
    grads = {}
    if train:
        total.backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return {"loss": float(total.detach()), "grad": grads, "stats": _stats(model), "out": out}


def _adam(model, cfg):
    return torch.optim.Adam(model.parameters(), lr=cfg["lr"], weight_decay=cfg["wd"],
                            foreach=False)


def _one_step(model, opt, d, ctx, cfg, fault=None):
    opt.zero_grad(set_to_none=True)
    out = model(d, ctx)
    if fault == "altered":  # the first scene's offsets moved by 1 m in x
        bump = torch.zeros_like(out["pt_offsets"])
        bump[:d["points"][0], 0] = 1.0
        out["pt_offsets"] = out["pt_offsets"] + bump
    if fault == "half":  # the loss over the first half of the scenes alone
        n = sum(d["points"][:max(1, len(d["points"]) // 2)])
        d = {**d, "sem_label": d["sem_label"].clone(), "ins_valid": d["ins_valid"].clone()}
        d["sem_label"][n:] = IGNORE
        d["ins_valid"][n:] = False
    total = loss(out, d)
    total.backward()
    grad = {n: (p.grad + cfg["wd"] * p).detach().clone() for n, p in model.named_parameters()}
    if fault != "frozen":
        opt.step()
    return float(total.detach()), grad


@no_tf32()
def train_steps(state, batches: List[dict], cfg: dict, momentum: float = 0.1,
                precision: Optional[str] = None, fault: Optional[str] = None,
                keep: bool = False) -> dict:
    """One Adam step a batch from ``state``: each step's loss, the first
    step's gradient as Adam takes it (weight decay added), the running
    statistics after the first step (``stats1``) and after the last
    (``stats``), the parameters after the last (with ``keep``, the whole
    state, Adam's with it, as ``snapshot``).  ``fault`` plants a fault a
    check has to catch: ``frozen`` (no step taken), ``half`` (the loss over
    the first half of the scenes alone), ``altered`` (the first scene's
    predicted offsets moved by 1 m)."""
    model = _model(state, cfg)
    opt = _adam(model, cfg)
    ctx = {"train": True, "momentum": momentum, "q": precision_of(precision)}
    losses, first_grad, stats1 = [], None, None
    for i, d in enumerate(batches):
        value, grad = _one_step(model, opt, d, ctx, cfg, fault)
        losses.append(value)
        if i == 0:
            first_grad, stats1 = grad, _stats(model)
    out = {"losses": losses, "first_grad": first_grad, "stats1": stats1, "stats": _stats(model),
           "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    if keep:
        out["snapshot"] = snapshot(model, opt)
    return out


def snapshot(model, opt) -> dict:
    """A train state taken whole, on the host: ``state`` and ``adam`` (by
    parameter name: ``step``, ``exp_avg``, ``exp_avg_sq``)."""
    adam = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            adam[n] = {"step": float(st["step"]), "exp_avg": st["exp_avg"].detach().cpu().clone(),
                       "exp_avg_sq": st["exp_avg_sq"].detach().cpu().clone()}
    return {"state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "adam": adam}


@no_tf32()
def step_from(snap: dict, d: dict, cfg: dict, device, momentum: float = 0.1,
              precision: Optional[str] = None, fault: Optional[str] = None,
              keep: bool = False) -> dict:
    """One Adam step of ``d`` from a state taken whole (``snapshot``): its
    loss, the gradient as Adam took it, the parameters and running
    statistics after (with ``keep``, the state after, whole)."""
    model = _model({k: v.to(device) for k, v in snap["state"].items()}, cfg)
    opt = _adam(model, cfg)
    for n, p in model.named_parameters():
        if n in snap["adam"]:
            a = snap["adam"][n]
            opt.state[p] = {"step": torch.tensor(a["step"], dtype=torch.float32),
                            "exp_avg": a["exp_avg"].to(device, copy=True),
                            "exp_avg_sq": a["exp_avg_sq"].to(device, copy=True)}
    ctx = {"train": True, "momentum": momentum, "q": precision_of(precision)}
    value, grad = _one_step(model, opt, d, ctx, cfg, fault)
    out = {"loss": value, "grad": {n: g.cpu() for n, g in grad.items()},
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
           "stats": {n: b.cpu() for n, b in _stats(model).items()}}
    if keep:
        out["snapshot"] = snapshot(model, opt)
    return out
