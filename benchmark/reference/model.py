"""InstanceRefer in plain PyTorch, float32: the reference the benchmark
holds the program against.  Written from the published model
(InstanceRefer, ICCV 2021: ``models/{lang,attribute,relation,scene}_module``
and ``lib/loss_helper.py`` of its repository) and imports nothing of the
program.  Parameter names are those of the published ``state_dict``, so one
set of weights loads into both; a sparse conv's kernel is [K, Cin, Cout]
over the offsets in ``voxels.py``'s order (x fastest), as the port stores
it (a published checkpoint orders torchsparse's offsets otherwise).

Departures from the published code, each shared with the program:
* sparse convs run over the maps of ``voxels.py`` (torchsparse's
  semantics), as sums of gathered rows times each offset's weight slice,
  in f32 (``precision`` rounds their inputs and outputs for the control);
* BatchNorm over voxels counts every voxel of the batch; in train mode the
  biased variance normalizes and the unbiased one enters the running
  variance, with momentum ``momentum``;
* the GRU is written out as its cell, run over each description's own
  length in both directions (what packing gives).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

WIDTHS = (32, 64, 128, 128, 128)
NUM_STAGES = 5
F32 = lambda t: t  # noqa: E731  -- the reference's own precision: none lost


class BN(nn.Module):
    """BatchNorm's parameters and running statistics; ``forward`` takes
    the mode and the momentum."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, train: bool, momentum: float, channel_dim: int = -1):
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            flat = x.movedim(channel_dim, -1).reshape(-1, x.shape[channel_dim])
            n = flat.shape[0]
            mean = flat.mean(0)
            var = (flat - mean).square().mean(0)
            with torch.no_grad():
                self.running_mean.mul_(1 - momentum).add_(momentum * mean)
                self.running_var.mul_(1 - momentum).add_(momentum * var * n / max(n - 1, 1))
                self.num_batches_tracked += 1
        return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps) \
            * self.weight.view(shape) + self.bias.view(shape)


class Kernel(nn.Module):
    """A sparse conv's weights [K, Cin, Cout], offsets as ``voxels.py``
    orders them."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))


class _SubmConv(torch.autograd.Function):
    """out[v] = sum_k x[nbr[v, k]] @ W[k]; the map is symmetric (offset
    26 - k is offset k mirrored), so dX[u] = sum_k g[nbr[u, k]] @ W[26-k]^T."""

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
        dx = None
        if ctx.needs_input_grad[0]:
            dx = ctx.q(_gather_sum(gq, nbr, wq.flip(0).transpose(1, 2)))
        return dx, _gather_dw(xq, nbr, gq), None, None


class _DownConv(torch.autograd.Function):
    """out[v] = sum_k x[down[v, k]] @ W[k]; each row u of the stage before
    feeds one row up[u] at one offset up_k[u]: dX[u] = g[up[u]] @ W[up_k[u]]^T."""

    @staticmethod
    def forward(ctx, x, w, down, up, up_k, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq, down, up, up_k)
        ctx.q = q
        return q(_gather_sum(xq, down, wq))

    @staticmethod
    def backward(ctx, g):
        xq, wq, down, up, up_k = ctx.saved_tensors
        gq = ctx.q(g)
        dx = torch.zeros_like(xq)
        for k in range(wq.shape[0]):
            rows = torch.nonzero(up_k == k)[:, 0]
            dx[rows] = gq[up[rows]] @ wq[k].T
        return ctx.q(dx), _gather_dw(xq, down, gq), None, None, None, None


def _table(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


def _gather_sum(x, nbr, w):
    table, safe = _table(x), torch.where(nbr >= 0, nbr, x.shape[0])
    out = x.new_zeros(nbr.shape[0], w.shape[2])
    for k in range(nbr.shape[1]):
        out = out + table[safe[:, k]] @ w[k]
    return out


def _gather_dw(x, nbr, g):
    table, safe = _table(x), torch.where(nbr >= 0, nbr, x.shape[0])
    return torch.stack([table[safe[:, k]].T @ g for k in range(nbr.shape[1])])


class Block(nn.Module):
    """Sparse conv (3^3 submanifold or 2^3 stride 2), BN, ReLU."""

    def __init__(self, cin: int, cout: int, ks: int):
        super().__init__()
        self.ks = ks
        self.net = nn.Sequential(Kernel(ks ** 3, cin, cout), BN(cout), nn.ReLU())

    def forward(self, x, stage, ctx):
        w = self.net[0].kernel
        if self.ks == 3:
            y = _SubmConv.apply(x, w, stage.nbr, ctx["q"])
        else:
            y = _DownConv.apply(x, w, stage.down, stage.up, stage.up_k, ctx["q"])
        return torch.relu(self.net[1](y, ctx["train"], ctx["momentum"]))


class Residual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.net = nn.Sequential(Kernel(27, c, c), BN(c), nn.ReLU(), Kernel(27, c, c), BN(c))

    def forward(self, x, stage, ctx):
        k1, bn1, _, k2, bn2 = self.net
        h = torch.relu(bn1(_SubmConv.apply(x, k1.kernel, stage.nbr, ctx["q"]), ctx["train"],
                           ctx["momentum"]))
        h = bn2(_SubmConv.apply(h, k2.kernel, stage.nbr, ctx["q"]), ctx["train"], ctx["momentum"])
        return torch.relu(h + x)


class Encoder(nn.Module):
    """Stem, then 4 x (stride-2 conv, residual block): Cin -> 32 -> 64 ->
    128 -> 128 -> 128."""

    def __init__(self, cin: int):
        super().__init__()
        self.stem = nn.Sequential(Block(cin, WIDTHS[0], 3))
        for i in range(1, NUM_STAGES):
            setattr(self, f"stage{i}", nn.Sequential(Block(WIDTHS[i - 1], WIDTHS[i], 2),
                                                     Residual(WIDTHS[i])))

    def forward(self, feats, stages, ctx):
        x = self.stem[0](feats, stages[0], ctx)
        for i in range(1, NUM_STAGES):
            stage = getattr(self, f"stage{i}")
            x = stage[1](stage[0](x, stages[i], ctx), stages[i], ctx)
        return x


class BEVKernel(nn.Module):
    def __init__(self, n: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n, cin, cout))


class Lang(nn.Module):
    HEADS = ("fc_a", "fc_cls", "fc_rel", "fc_scene")

    def __init__(self, num_classes: int, dropout: float):
        super().__init__()
        self.word_projection = nn.Sequential(nn.Linear(300, 256), nn.ReLU(), nn.Dropout(dropout),
                                             nn.Linear(256, 256), nn.ReLU())
        self.gru = nn.GRU(256, 128, num_layers=2, batch_first=True, bidirectional=True)
        for name in self.HEADS:
            setattr(self, name, nn.Linear(256, 1))
        self.lang_cls = nn.Sequential(nn.Linear(256, num_classes))


class Attribute(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.net = Encoder(cin)
        self.vis_emb_fc = nn.Sequential(nn.Linear(128, 256), nn.LayerNorm(256), nn.ReLU(),
                                        nn.Linear(256, 256))
        self.lang_emb_fc = nn.Sequential(nn.Linear(256, 256), BN(256), nn.ReLU(),
                                         nn.Linear(256, 256))


class EdgeConv(nn.Module):
    def __init__(self, f_in: int, num_classes: int):
        super().__init__()
        self.weight = nn.Sequential(nn.Linear(3 + 2 * num_classes, 64), nn.ReLU(),
                                    nn.Linear(64, f_in))
        self.mlp = nn.Sequential(nn.Linear(3 * f_in, 128), nn.ReLU(), nn.Linear(128, 128))


class Relation(nn.Module):
    def __init__(self, cin: int, num_classes: int, dropout: float):
        super().__init__()
        self.gcn = EdgeConv(cin + num_classes, num_classes)
        self.vis_emb_fc = nn.Sequential(nn.Linear(128, 128), nn.LayerNorm(128), nn.ReLU(),
                                        nn.Dropout(dropout), nn.Linear(128, 128))
        self.lang_emb_fc = nn.Sequential(nn.Linear(256, 128), BN(128), nn.ReLU(),
                                         nn.Dropout(dropout), nn.Linear(128, 128))


class SceneNet(nn.Module):
    def __init__(self, cin: int, dropout: float):
        super().__init__()
        self.net = Encoder(cin)
        self.to_bev = nn.Sequential(nn.Identity(), BEVKernel(5, 128, 128), BN(128), nn.ReLU())
        self.vis_emb_fc = nn.Sequential(nn.Conv2d(128, 128, 3), BN(128), nn.ReLU(),
                                        nn.Dropout(dropout), nn.Conv2d(128, 128, 3))
        self.vis_emb_fc1 = nn.Sequential(nn.Linear(128, 128), nn.LayerNorm(128), nn.ReLU(),
                                         nn.Dropout(dropout), nn.Linear(128, 128))
        self.lang_emb_fc = nn.Sequential(nn.Linear(256, 128), nn.LayerNorm(128), nn.ReLU(),
                                         nn.Dropout(dropout), nn.Linear(128, 128))
        self.cls = nn.Sequential(nn.Linear(128, 128), BN(128), nn.ReLU(), nn.Linear(128, 9))


class InstanceRefer(nn.Module):
    """The parameters; ``forward`` is the module function ``forward``."""

    def __init__(self, cin: int, num_classes: int = 18, dropout: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.lang = Lang(num_classes, dropout)
        self.attribute = Attribute(cin)
        self.relation = Relation(cin, num_classes, dropout)
        self.scene = SceneNet(cin, dropout)


@torch.no_grad()
def init_state(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` by torch's default rules (U(+-1/sqrt(fan_in))
    for linear, conv and sparse-conv weights and biases, fan_in = K x Cin
    for a sparse conv and Cin for the BEV kernels; U(+-1/sqrt(hidden)) for
    the GRU; ones and zeros for the norms), drawn on ``device`` in one call;
    the running statistics at their start.  Returns the state dict, which
    both sides load."""
    bounds = []
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan = m.weight[0].numel()
            bounds += [(m.weight, fan), (m.bias, fan)]
        elif isinstance(m, Kernel):
            bounds.append((m.kernel, m.kernel.shape[0] * m.kernel.shape[1]))
        elif isinstance(m, BEVKernel):
            bounds.append((m.kernel, m.kernel.shape[1]))
        elif isinstance(m, nn.GRU):
            bounds += [(p, m.hidden_size) for p in m.parameters()]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(p.numel() for p, _ in bounds)
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    model.to(device)
    at = 0
    for p, fan in bounds:
        p.copy_(draw[at:at + p.numel()].view_as(p) / math.sqrt(max(fan, 1)))
        at += p.numel()
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, BN)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# ----------------------------------------------------------------------------- forward


def _gru_direction(x, lengths, w_ih, w_hh, b_ih, b_hh, reverse: bool):
    """One direction of one GRU layer over each row's first ``length``
    steps; zeros beyond."""
    b, t, _ = x.shape
    h = x.new_zeros(b, w_hh.shape[1])
    gi_all = x @ w_ih.T + b_ih
    outs = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        gh = h @ w_hh.T + b_hh
        gi = gi_all[:, step]
        r = torch.sigmoid(gi[:, :128] + gh[:, :128])
        z = torch.sigmoid(gi[:, 128:256] + gh[:, 128:256])
        n = torch.tanh(gi[:, 256:] + r * gh[:, 256:])
        live = (step < lengths)[:, None]
        h = torch.where(live, (1 - z) * n + z * h, h)
        outs[step] = torch.where(live, h, 0.0)
    return torch.stack(outs, 1)


def lang_forward(m: Lang, d: dict, ctx: dict) -> dict:
    feats, lengths = d["lang_feat"], d["lang_len"]
    embed = _seq(m.word_projection, feats, ctx)
    x = embed
    for layer in range(2):
        dirs = []
        for suffix, reverse in (("", False), ("_reverse", True)):
            p = [getattr(m.gru, f"{n}_l{layer}{suffix}")
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            dirs.append(_gru_direction(x, lengths, *p, reverse=reverse))
        x = torch.cat(dirs, -1)
    mask = torch.arange(feats.shape[1], device=feats.device)[None] < lengths[:, None]
    out = {}
    for name in m.HEADS:
        logits = getattr(m, name)(x).squeeze(-1).masked_fill(~mask, float("-inf"))
        atten = torch.softmax(logits, 1)
        out[name] = (atten[..., None] * embed).sum(1)
    out["lang_scores"] = m.lang_cls(out["fc_cls"])
    return out


def _cosine(a, b, eps: float = 1e-8):
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=eps)


def _seq(fc, x, ctx, bn_rows=None):
    """A Sequential of Linear / LayerNorm / BN / ReLU / Dropout layers."""
    for layer in fc:
        if isinstance(layer, BN):
            x = layer(x, ctx["train"], ctx["momentum"])
        elif isinstance(layer, nn.Dropout):
            x = F.dropout(x, layer.p, ctx["train"])
        else:
            x = layer(x)
    return x


def forward(model: InstanceRefer, d: dict, ctx: dict) -> dict:
    """Scores of a prepared batch (``batch.prepare``): ``ctx`` holds
    ``train``, ``momentum``, ``k`` (the relation's neighbours) and ``q``
    (the sparse convs' rounding)."""
    out = lang_forward(model.lang, d, ctx)
    b, c = d["cand_mask"].shape

    # attribute: the candidates' encoder, a max pool per candidate
    att = model.attribute
    lang = F.normalize(_seq(att.lang_emb_fc, out["fc_a"], ctx), dim=1, eps=1e-12)
    pooled = d["inst_feats"].new_zeros(b * c, 128)
    inst = d["inst_stages"]
    if len(inst[0].coords):
        feats = att.net(d["inst_feats"], inst, ctx)
        group = inst[-1].group
        most = feats.new_full((b * c, 128), float("-inf")).scatter_reduce(
            0, group[:, None].expand(-1, 128), feats, "amax")
        has = torch.zeros(b * c, dtype=torch.bool, device=feats.device).index_fill(0, group, True)
        pooled = torch.where(has[:, None], most, 0.0)
    pooled = pooled.view(b, c, 128)
    vis = F.normalize(_seq(att.vis_emb_fc, pooled, ctx), dim=-1, eps=1e-12)
    out["attribute_scores"] = (vis * lang[:, None]).sum(-1)

    # relation: kNN from each candidate to the scene's instances, EdgeConv
    rel = model.relation
    nc = model.num_classes
    node = torch.cat([d["node_feat"], F.one_hot(d["inst_class"], nc).float()
                      * d["inst_mask"][..., None]], -1)
    xyz = d["inst_obbs"][..., :3]
    q_idx = d["cand_slot"]
    take = lambda x, i: torch.gather(  # noqa: E731
        x, 1, i.reshape(b, -1, 1).expand(-1, -1, x.shape[-1])).view(*i.shape, x.shape[-1])
    q_xyz, q_feat = take(xyz, q_idx), take(node, q_idx)
    d2 = ((q_xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    d2 = d2.masked_fill(~d["inst_mask"][:, None], float("inf"))
    k = min(ctx["k"], d2.shape[-1])
    top, idx = torch.topk(d2, k, dim=-1, largest=False)
    idx = torch.where(torch.isfinite(top), idx, idx[..., :1])
    x_j = take(node, idx)
    x_i = q_feat[:, :, None].expand_as(x_j)
    pos = take(xyz, idx) - q_xyz[:, :, None]
    w = _seq(rel.gcn.weight, torch.cat([pos, x_i[..., -nc:], x_j[..., -nc:]], -1), ctx)
    msg = _seq(rel.gcn.mlp, torch.cat([x_i, w, x_j], -1), ctx).amax(2)
    msg = torch.where(d["cand_mask"][..., None], msg, 0.0)
    vis_r = _seq(rel.vis_emb_fc, msg, ctx)
    lang_r = _seq(rel.lang_emb_fc, out["fc_rel"], ctx)
    out["relation_scores"] = _cosine(vis_r, lang_r[:, None])

    # scene: the BEV encoder, a dense BEV of the crop, attention over its cells
    sc = model.scene
    final = d["scene_stages"][-1]
    feats = sc.net(d["scene_feats"], d["scene_stages"], ctx)
    cs = final.coords
    crop = (cs[:, 0] >= 0) & (cs[:, 0] < 240) & (cs[:, 1] >= 0) & (cs[:, 1] < 400) \
        & (cs[:, 2] >= 0) & (cs[:, 2] < 80)
    zbin = torch.div(cs[:, 2], 16, rounding_mode="floor").clamp(0, 4)
    rows = feats.new_zeros(len(feats), 128)
    for z in range(5):
        rows = rows + (feats * (zbin == z)[:, None]) @ sc.to_bev[1].kernel[z]
    bx = torch.div(cs[:, 0], 16, rounding_mode="floor").clamp(0, 14)
    by = torch.div(cs[:, 1], 16, rounding_mode="floor").clamp(0, 24)
    cell = (final.group * 15 + bx) * 25 + by
    bev = feats.new_zeros(b * 15 * 25, 128).index_add(0, cell[crop], rows[crop])
    bev = torch.relu(sc.to_bev[2](bev.view(b, 15, 25, 128), ctx["train"], ctx["momentum"]))
    x = sc.vis_emb_fc[0](bev.permute(0, 3, 1, 2))
    x = torch.relu(sc.vis_emb_fc[1](x, ctx["train"], ctx["momentum"], channel_dim=1))
    x = sc.vis_emb_fc[4](F.dropout(x, sc.vis_emb_fc[3].p, ctx["train"]))
    cells = x.flatten(2).transpose(1, 2)  # [B, 231, 128]
    lang_s = _seq(sc.lang_emb_fc, out["fc_scene"], ctx)
    atten = torch.softmax((cells @ lang_s[..., None])[..., 0] / math.sqrt(128), 1)
    scene_feats = (atten[..., None] * cells).sum(1)
    out["seg_scores"] = _seq(sc.cls, scene_feats, ctx)
    out["scene_scores"] = _cosine(_seq(sc.vis_emb_fc1, pooled, ctx), scene_feats[:, None])
    return out


def precision_of(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of the sparse convs' inputs and outputs: ``None`` for
    f32; ``"fp8"`` rounds each tensor to float8 e4m3 under a per-tensor
    scale (its largest magnitude to 448), the control."""
    if name is None:
        return F32
    if name != "fp8":
        raise ValueError(f"no precision {name!r}")

    def fp8(t: torch.Tensor) -> torch.Tensor:
        amax = t.detach().abs().max()
        if not bool(amax > 0):
            return t
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return fp8
