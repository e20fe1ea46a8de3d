"""Sparse-conv building blocks over padded ``SparseStage`` pyramids.

Counterpart of ``instancerefer_tpu/models/basic_blocks.py``.  Module and
parameter names follow the reference's ``state_dict`` (``stem.0.net.0.kernel``,
``stage1.1.net.3.kernel``, ...), so converted weights load by name.

Eval mode: every BatchNorm of an encoder folds into a per-channel affine that
the CUDA kernel K1 applies (with the ReLU) to its f32 accumulator, where the
JAX package fuses it (``models/basic_blocks.py:303-309,334-341``).  Train
mode: conv with no epilogue (``ops/sparse_conv``: K1 forward, K2/K3
backward) -> masked BatchNorm over the stage's valid rows -> ReLU, as
``models/basic_blocks.py:310-317,342-347``.  Train/eval follows
``nn.Module.train()``.

Sparse-conv kernels are stored [K, Cin, Cout] in the offset order of the
host maps (``instancerefer_tpu/ops/voxelize.KERNEL_OFFSETS_3/2``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from instancerefer_tpu_torch.data.host import SparseStage
from instancerefer_tpu_torch.ops.gather_conv import gather_conv
from instancerefer_tpu_torch.ops.precision import cast_in
from instancerefer_tpu_torch.ops.sparse_conv import down_conv, stem_input, subm_conv
from instancerefer_tpu_torch.parallel.distributed import all_reduce_sum, world_size


class MaskedBatchNorm(nn.Module):
    """BatchNorm over padded rows, with torch's parameter/buffer names.

    Train mode (``models/basic_blocks.py:101-153``): normalizes channel
    ``channel_dim`` by the batch statistics of the rows where ``mask`` is
    True (all rows for ``mask=None``), computed in f32 whatever the input
    dtype (in bf16 the E[x^2] - mean^2 cancellation is lost); the biased
    variance normalizes, the unbiased ``var * n / max(n - 1, 1)`` enters
    ``running_var``, and ``momentum`` weighs the new batch as torch's BN
    does (the BN-momentum schedule sets it).  Eval mode normalizes with the
    running statistics.  The output keeps the input dtype.

    Data-parallel (world size > 1): the statistics are those of the global
    batch, as JAX's BN over the global array.  Each rank sums [sum x,
    sum x^2, n] over its valid rows, one ``all_reduce_sum`` of that
    [2C + 1] vector adds the ranks', and mean, variance and the running
    statistics follow from the global sums, equal on every rank.  The
    all-reduce is differentiable, so the backward adds the ranks' gradients
    of the sums and dX is that of one BN over the union of the rows.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def fold_eval(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale', bias') with y = x * scale' + bias':
        scale' = weight / sqrt(var + eps), bias' = bias - mean * scale'."""
        sc = self.weight * torch.rsqrt(self.running_var + self.eps)
        return sc, self.bias - self.running_mean * sc

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                channel_dim: int = -1) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        if not self.training:
            sc = self.fold_eval()[0]
            y = (x.float() - self.running_mean.view(shape)) * sc.view(shape) + self.bias.view(shape)
            return y.to(x.dtype)
        flat = x.float().movedim(channel_dim, -1).reshape(-1, x.shape[channel_dim])
        if world_size() > 1:
            mean, var, n = _global_moments(flat, mask)
        elif mask is None:
            n = torch.tensor(float(flat.shape[0]), device=x.device)
            mean = flat.mean(0)
            var = flat.square().mean(0) - mean.square()
        else:
            rows = mask.reshape(-1, 1).float()
            n = rows.sum().clamp(min=1.0)
            mean = (flat * rows).sum(0) / n
            var = (flat.square() * rows).sum(0) / n - mean.square()
        var = var.clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            unbiased = var * n / (n - 1.0).clamp(min=1.0)
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
            self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def _global_moments(flat: torch.Tensor, mask: Optional[torch.Tensor]):
    """(mean, biased variance, row count) of ``flat``'s masked rows over
    every rank, from one all-reduce of their sums."""
    c = flat.shape[1]
    if mask is None:
        rows = flat.new_ones(flat.shape[0], 1)
    else:
        rows = mask.reshape(-1, 1).float()
    sums = all_reduce_sum(torch.cat([(flat * rows).sum(0), (flat.square() * rows).sum(0),
                                     rows.sum().view(1)]))
    n = sums[2 * c].clamp(min=1.0)
    mean = sums[:c] / n
    return mean, sums[c:2 * c] / n - mean.square(), n


class SparseConv(nn.Module):
    """Weights of one sparse conv (torchsparse ``spnn.Conv3d``, no bias):
    ``kernel`` [K, Cin, Cout], K = 27 (3^3 submanifold) or 8 (2^3 stride 2).
    Zeros until ``models/instancerefer.init_parameters`` or a state_dict
    fills them."""

    def __init__(self, cin: int, cout: int, volume: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(volume, cin, cout))


def _fused_eval(x, nbr, conv: SparseConv, bn: MaskedBatchNorm, relu: bool):
    sc, bi = bn.fold_eval()
    return gather_conv(x, nbr, cast_in(conv.kernel).contiguous(), sc.contiguous(),
                       bi.contiguous(), relu)


class BasicConvolutionBlock(nn.Module):
    """Conv3d + BN + ReLU; ks 3 = submanifold over ``nbr3``, ks 2 = stride-2
    over ``down`` (reference ``models/basic_blocks.py:10-25``).
    ``grad_input=False`` (the stems): the input is a leaf, so the train
    backward computes dW only."""

    def __init__(self, cin: int, cout: int, ks: int, grad_input: bool = True):
        super().__init__()
        self.ks = ks
        self.grad_input = grad_input
        self.net = nn.Sequential(
            SparseConv(cin, cout, ks ** 3), MaskedBatchNorm(cout), nn.ReLU()
        )

    def forward(self, x: torch.Tensor, sv: SparseStage) -> torch.Tensor:
        conv, bn = self.net[0], self.net[1]
        if not self.training:
            return _fused_eval(x, sv.nbr3 if self.ks == 3 else sv.down, conv, bn, relu=True)
        if self.ks == 3:
            x = subm_conv(x, sv.nbr3, conv.kernel, self.grad_input)
        else:
            x = down_conv(x, sv.down, sv.up8, conv.kernel)
        return torch.relu(bn(x, sv.mask))


class ResidualBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + identity, ReLU (reference
    ``models/basic_blocks.py:28-56``; every use has inc == outc, stride 1)."""

    def __init__(self, c: int):
        super().__init__()
        self.net = nn.Sequential(
            SparseConv(c, c, 27), MaskedBatchNorm(c), nn.ReLU(),
            SparseConv(c, c, 27), MaskedBatchNorm(c),
        )

    def forward(self, x: torch.Tensor, sv: SparseStage) -> torch.Tensor:
        conv1, bn1, _, conv2, bn2 = self.net
        if not self.training:
            h = _fused_eval(x, sv.nbr3, conv1, bn1, relu=True)
            h = _fused_eval(h, sv.nbr3, conv2, bn2, relu=False)
        else:
            h = torch.relu(bn1(subm_conv(x, sv.nbr3, conv1.kernel), sv.mask))
            h = bn2(subm_conv(h, sv.nbr3, conv2.kernel), sv.mask)
        return torch.relu(h + x)


class SparseConvEncoder(nn.Module):
    """Stem + 4 x [stride-2 conv, residual block]; channels
    in -> 32 -> 64 -> 128 -> 128 -> 128.  Returns the stride-16 stage's
    features in f32 (the stem takes Cin as it is; ``stem_input`` pads it to
    16-byte rows only for the card's stem kernels).  The
    stem input is raw point features, a leaf: it is detached and the stem's
    backward computes dW only (``models/basic_blocks.py:366-372``)."""

    def __init__(self, cin: int, widths: Sequence[int] = (32, 64, 128, 128, 128)):
        super().__init__()
        w = widths
        self.stem = nn.Sequential(BasicConvolutionBlock(cin, w[0], 3, grad_input=False))
        for i in range(1, 5):
            setattr(self, f"stage{i}", nn.Sequential(
                BasicConvolutionBlock(w[i - 1], w[i], 2),
                ResidualBlock(w[i]),
            ))

    def forward(self, feats: torch.Tensor, pyramid: Sequence[SparseStage]) -> torch.Tensor:
        x = self.stem[0](stem_input(feats), pyramid[0])
        for i in range(1, 5):
            stage = getattr(self, f"stage{i}")
            x = stage[0](x, pyramid[i])
            x = stage[1](x, pyramid[i])
        return x.float()


BEVEncoder = SparseConvEncoder  # same topology (reference :136-171)


def sparse_crop_mask(sv: SparseStage, loc_min, loc_max) -> torch.Tensor:
    """Rows whose coords lie in [loc_min, loc_max) — reference ``spcrop`` as a mask."""
    lo = torch.tensor(loc_min, dtype=sv.coords.dtype, device=sv.coords.device)
    hi = torch.tensor(loc_max, dtype=sv.coords.dtype, device=sv.coords.device)
    return ((sv.coords >= lo) & (sv.coords < hi)).all(-1) & sv.mask


class ToDenseBEVConvolution(nn.Module):
    """Per-z-bin linear kernels + scatter-add into a dense [B, H, W, C] BEV
    (reference ``models/basic_blocks.py:195-243``): n_z masked GEMMs, then
    ``index_add_`` with cropped rows dumped into one extra cell; it
    differentiates as plain torch ops.  On the card ``index_add_`` sums with
    atomics, in no fixed order."""

    def __init__(self, cin: int, cout: int, bev_shape: Tuple[int, int], n_kernels: int):
        super().__init__()
        self.bev_shape = bev_shape
        self.n_kernels = n_kernels
        self.kernel = nn.Parameter(torch.zeros(n_kernels, cin, cout))  # see SparseConv

    def forward(self, feats, sv: SparseStage, crop_mask, batch_size: int):
        h, w = self.bev_shape
        stride = sv.stride
        cout = self.kernel.shape[2]
        zbin = (sv.coords[:, 2] // stride).clamp(0, self.n_kernels - 1)
        rows = feats.new_zeros(feats.shape[0], cout)
        for z in range(self.n_kernels):
            rows = rows + (feats * (zbin == z)[:, None]) @ self.kernel[z]
        bx = (sv.coords[:, 0] // stride).clamp(0, h - 1).long()
        by = (sv.coords[:, 1] // stride).clamp(0, w - 1).long()
        lin = (sv.owner.clamp(min=0) * h + bx) * w + by
        lin = torch.where(crop_mask, lin, batch_size * h * w)
        grid = rows.new_zeros(batch_size * h * w + 1, cout)
        grid.index_add_(0, lin, rows * crop_mask[:, None])
        return grid[:-1].view(batch_size, h, w, cout)
