"""PointGroup's first training phase (Jiang et al., "PointGroup: Dual-Set
Point Grouping for 3D Instance Segmentation", CVPR 2020; code
``model/pointgroup/pointgroup.py``, ``config/pointgroup_run1_scannet.yaml``
at github.com/dvlab-research/PointGroup): the seven-level sparse U-Net and
the semantic and offset heads, the step of its ``prepare_epochs`` (epochs
1-128; clustering and ScoreNet join after them and are not ported).

Equations (spconv's semantics; every BN is BatchNorm1d with eps 1e-4 over
the batch's valid voxels, or its valid points in the offset head):

* ``input_conv``: SubM3(6 -> m), no bias, on the voxels' mean [rgb, xyz];
* ``UBlock(nPlanes)``, nPlanes = (m, 2m, ..., 7m), ``block_reps`` residual
  blocks, then where a deeper level exists: ``conv`` = BN -> ReLU ->
  SparseConv3d(c -> c', k 2, s 2), the next UBlock, ``deconv`` = BN -> ReLU
  -> SparseInverseConv3d(c' -> c) over the same map, [skip, decoded]
  concatenated (2c), and ``blocks_tail``: Res(2c -> c), then Res(c -> c);
* ``Res(a -> b)``: SubM3(b -> b)(ReLU(BN(SubM3(a -> b)(ReLU(BN(x)))))) +
  i(x), i the identity or, a != b, a 1 x 1 SubM(a -> b) with no bias (a
  dense GEMM over the rows);
* ``output_layer``: BN -> ReLU; each point takes its voxel's row;
* ``linear``: Linear(m -> 20), the semantic scores; ``offset``: Linear(m ->
  m) -> BN -> ReLU, then ``offset_linear``: Linear(m -> 3).

On the port: every sparse conv runs on its kernels (``ops/sparse_conv``:
the input conv on the stem route, the 3^3 convs, downs and inverse convs on
the tensor-core kernels at the widths 16-192, in the compute dtype with f32
accumulation), every BN with its ReLU is one ``ops/masked_bn`` call
(``MaskedBatchNorm.fused``: the CUDA pair on a card), each level's down map
runs one list pass (``conv_bwd.down_lists``) that the down conv's backward
and the inverse conv's three kernels share.  A pyramid is
``data/pointgroup``'s: ``SparseStage`` levels of padded rows.

Weights are stored [K, Cin, Cout] over the host maps' offsets
(``ops/voxelize``), spconv's [k, k, k, Cin, Cout] in another order; names
follow PointGroup's modules (``input_conv.0``, ``unet.blocks.block0.
conv_branch.2``, ``unet.u.conv.2``, ``unet.deconv.2``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from instancerefer_tpu_torch.data.host import SparseStage
from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm, SparseConv
from instancerefer_tpu_torch.ops.conv_bwd import down_lists
from instancerefer_tpu_torch.ops.precision import cast_in
from instancerefer_tpu_torch.ops.sparse_conv import (
    down_conv, inverse_conv, stem_input, subm_conv,
)
from instancerefer_tpu_torch.utils.profiling import span

SEM_CLASSES = 20
BN_EPS = 1e-4


def _bn(c: int, eps: float) -> MaskedBatchNorm:
    return MaskedBatchNorm(c, eps=eps)


class ResidualBlock(nn.Module):
    """PointGroup's ``ResidualBlock``: pre-activation BN -> ReLU -> SubM3,
    twice, plus the identity or a 1 x 1 conv."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        if cin != cout:
            self.i_branch = nn.Sequential(SparseConv(cin, cout, 1))
        self.conv_branch = nn.Sequential(_bn(cin, eps), nn.ReLU(), SparseConv(cin, cout, 27),
                                         _bn(cout, eps), nn.ReLU(), SparseConv(cout, cout, 27))

    def forward(self, x: torch.Tensor, sv: SparseStage) -> torch.Tensor:
        bn1, _, conv1, bn2, _, conv2 = self.conv_branch
        h = subm_conv(bn1.fused(x, sv.mask), sv.nbr3, conv1.kernel)
        h = subm_conv(bn2.fused(h, sv.mask), sv.nbr3, conv2.kernel)
        if hasattr(self, "i_branch"):
            return h + cast_in(x) @ cast_in(self.i_branch[0].kernel[0])
        return h + x


class UBlock(nn.Module):
    """One level of the U-Net and, below it, the rest."""

    def __init__(self, planes: Sequence[int], block_reps: int, eps: float, level: int = 0):
        super().__init__()
        c = planes[0]
        self.level = level
        self.blocks = nn.ModuleDict({f"block{i}": ResidualBlock(c, c, eps)
                                     for i in range(block_reps)})
        if len(planes) > 1:
            self.conv = nn.Sequential(_bn(c, eps), nn.ReLU(), SparseConv(c, planes[1], 8))
            self.u = UBlock(planes[1:], block_reps, eps, level + 1)
            self.deconv = nn.Sequential(_bn(planes[1], eps), nn.ReLU(),
                                        SparseConv(planes[1], c, 8))
            self.blocks_tail = nn.ModuleDict({
                f"block{i}": ResidualBlock(c * (2 - i), c, eps) for i in range(block_reps)})

    def forward(self, x: torch.Tensor, pyramid: Sequence[SparseStage]) -> torch.Tensor:
        sv = pyramid[self.level]
        for block in self.blocks.values():
            x = block(x, sv)
        if not hasattr(self, "u"):
            return x
        nxt = pyramid[self.level + 1]
        with span("ir.unet.down", level=self.level):
            lists = down_lists(nxt.down)
            bn, _, conv = self.conv
            d = down_conv(bn.fused(x, sv.mask), nxt.down, nxt.up8,
                          conv.kernel, lists)
        d = self.u(d, pyramid)
        with span("ir.unet.up", level=self.level):
            bn, _, conv = self.deconv
            d = inverse_conv(bn.fused(d, nxt.mask), nxt.down, nxt.up8, conv.kernel, lists)
        with span("ir.unet.tail", level=self.level):
            x = torch.cat([x, d], 1)
            for block in self.blocks_tail.values():
                x = block(x, sv)
        return x


class PointGroup(nn.Module):
    """The U-Net and the two heads; ``forward(dd)`` takes a data dict of
    ``data/pointgroup`` (``feats``, ``pyramid``, ``p2v``, ``point_mask``)
    and returns ``semantic_scores`` [P, 20] and ``pt_offsets`` [P, 3] (f32,
    every padded point)."""

    def __init__(self, cin: int = 6, m: int = 16, num_levels: int = 7, block_reps: int = 2,
                 classes: int = SEM_CLASSES, eps: float = BN_EPS):
        super().__init__()
        self.input_conv = nn.Sequential(SparseConv(cin, m, 27))
        self.unet = UBlock([m * (i + 1) for i in range(num_levels)], block_reps, eps)
        self.output_layer = nn.Sequential(_bn(m, eps), nn.ReLU())
        self.linear = nn.Linear(m, classes)
        self.offset = nn.Sequential(nn.Linear(m, m), _bn(m, eps), nn.ReLU())
        self.offset_linear = nn.Linear(m, 3)

    def set_bn_momentum(self, momentum: float) -> None:
        for mod in self.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.momentum = momentum

    def forward(self, dd: Dict) -> Dict[str, torch.Tensor]:
        pyramid = dd["pyramid"]
        sv = pyramid[0]
        with span("ir.fwd.unet"):
            x = subm_conv(stem_input(dd["feats"]), sv.nbr3, self.input_conv[0].kernel,
                          grad_input=False)
            x = self.unet(x, pyramid)
            x = self.output_layer[0].fused(x, sv.mask)
        with span("ir.fwd.heads"):
            # index_select: its backward adds the points' rows into their
            # voxels' with one index_add, where indexing's sorts them first
            feats = torch.index_select(x.float(), 0, dd["p2v"])
            sem = self.linear(feats)
            h = self.offset[1].fused(self.offset[0](feats), dd["point_mask"])
            off = self.offset_linear(h)
        return {"semantic_scores": sem, "pt_offsets": off}


def init_parameters(model: PointGroup, generator: torch.Generator) -> None:
    """spconv's and torch's default initialization from ``generator``: a
    sparse conv's kernel uniform within 1 / sqrt(K Cin) (kaiming uniform, a
    = sqrt(5)), a Linear's weight and bias likewise over its fan-in; BN
    weight 1, bias 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SparseConv):
                k, cin, _ = mod.kernel.shape
                bound = 1.0 / math.sqrt(k * cin)
                mod.kernel.copy_(torch.rand(mod.kernel.shape, generator=generator) * 2 * bound
                                 - bound)
            elif isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)


def loss(out: Dict[str, torch.Tensor], dd: Dict) -> Dict[str, torch.Tensor]:
    """PointGroup's first-phase loss, each term weighted 1: cross entropy
    over the labelled points (-100 ignored), and over the points of an
    instance the L1 offset error and the negative cosine of the offset's
    direction, each summed over them / (their count + 1e-6).  Also the
    semantic accuracy over the labelled points."""
    sem, off = out["semantic_scores"], out["pt_offsets"]
    labels = torch.where(dd["point_mask"], dd["sem_label"], -100)
    sem_loss = F.cross_entropy(sem, labels, ignore_index=-100)
    valid = dd["ins_valid"].float()
    count = valid.sum() + 1e-6
    gt = dd["gt_offset"]
    norm_loss = ((off - gt).abs().sum(-1) * valid).sum() / count
    gt_dir = gt / (gt.norm(dim=1, keepdim=True) + 1e-8)
    pt_dir = off / (off.norm(dim=1, keepdim=True) + 1e-8)
    dir_loss = (-(gt_dir * pt_dir).sum(-1) * valid).sum() / count
    labelled = (labels != -100).float()
    acc = ((sem.argmax(1) == labels).float() * labelled).sum() / labelled.sum().clamp(min=1.0)
    return {"loss": sem_loss + norm_loss + dir_loss, "semantic_loss": sem_loss,
            "offset_norm_loss": norm_loss, "offset_dir_loss": dir_loss, "semantic_acc": acc}
