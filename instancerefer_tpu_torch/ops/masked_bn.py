"""Masked BatchNorm of the sparse encoders' train path, fused with the op
that follows it: ``masked_bn``, a ``torch.autograd.Function`` over the
CUDA kernels of ``csrc/masked_bn.cu``.

    y = relu((x - mean) * scale + bias [+ residual])
    scale = weight * rsqrt(var + eps)

mean and the biased variance (E[x^2] - mean^2, clamped at 0, in f32) come
from the rows where ``mask`` is set (every row for ``mask=None``), n
clamped at 1; ``running_mean`` and ``running_var`` (the unbiased
``var * n / max(n - 1, 1)``) move by the device scalar ``momentum`` as
``models/basic_blocks.MaskedBatchNorm`` moves them; the residual adds in
f32 before the one rounding to x's dtype.  The backward is the closed form
of autograd over that expression:

    g = dy * [y > 0]
    dbias = sum g,  dweight = sum g * xh,  xh = (x - mean) * rsqrt(var + eps)
    dx = scale * (g - m * (dbias / n + xh * dweight / n)),  dresidual = g

with both sums over every row (each row's output depends on the batch
statistics) and m the row mask; the xh term drops where the variance was
clamped, as the clamp's gradient does.

The pair runs as passes: the statistics' sums, their total (statistics and
running statistics), y; then the gradient's sums, their total, dx.  On a
card each is a kernel (``csrc/masked_bn.cu``, launched on PyTorch's current
stream; nothing is read back to the host, so a step that calls it can be
captured as a CUDA graph); for CPU tensors each is its plain twin here,
the same arithmetic in PyTorch ops (``forward_passes`` and
``backward_passes`` run either on any device, for a card's comparison).
A CUDA tensor launches the kernels or raises: no fallback.

Data-parallel (world size > 1): the sums [sum x, sum x^2, n] are
all-reduced before the statistics, and [sum g, sum g * xh] before dx, so y
and dx are those of one BN over the union of the ranks' rows; dweight and
dbias stay each rank's own sums, which DDP averages.

``masked_bn.launches`` counts forward calls on a card and
``masked_bn.bwd_launches`` backward ones (each a chain of three kernels,
or four with the all-reduce's total): an InstanceRefer train step makes
26 of each, one per encoder BN.  The pre-activation BNs of PointGroup's
U-Net (BN -> ReLU -> conv) are the form with no residual.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from instancerefer_tpu_torch.ops.gather_conv import (
    DTYPES, check_launch, cuda_stream, library, sm_count,
)
from instancerefer_tpu_torch.parallel.distributed import all_reduce_sum, world_size

# the widths the kernels are built for: InstanceRefer's encoders, and
# PointGroup's U-Net (m = 16: 16 to 112, the tails' 2m to 192)
CHANNELS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192)
THREADS = 256  # a block (csrc/masked_bn.cu)
UNROLL = {"fwd": 4, "bwd": 2}  # 16-byte loads a thread keeps in flight, by pass
BLOCKS_PER_SM = 4

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = {
    "ir_masked_bn_stats": [_P, _P, _P, _L, _I, _I, _I, _P],
    "ir_masked_bn_total": [_P, _P, _P, _I, _I, _I, _P],
    "ir_masked_bn_finalize": [_P] * 6 + [_I, _I, ctypes.c_float, _P],
    "ir_masked_bn_apply": [_P] * 5 + [_L, _I, _I, _I, _P],
    "ir_masked_bn_bwd_reduce": [_P] * 5 + [_L, _I, _I, _I, _P],
    "ir_masked_bn_bwd_apply": [_P] * 9 + [_L, _I, _I, _I, _P],
}


@functools.cache
def _entry(name: str):
    fn = getattr(library("masked_bn"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGS[name]
    return fn


def _launch(name: str, *args) -> None:
    check_launch(name, _entry(name)(*args))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def blocks(rows: int, c: int, dtype: torch.dtype, pass_: str, sms: int,
           per_row: bool = True) -> int:
    """Blocks of a pass over ``rows`` x ``c`` elements of ``dtype``: enough
    that each thread keeps ``UNROLL[pass_]`` 16-byte loads in flight, at
    most ``BLOCKS_PER_SM`` a card's SM.  The reduction passes stride over
    rows (``per_row``), the others over 16-byte vectors; a function of the
    shape and the card alone, so a shape always sums in one order."""
    vec = 128 // torch.finfo(dtype).bits  # elements a 16-byte vector
    per_step = THREADS * UNROLL[pass_]
    if per_row:
        per_step //= c // vec
    units = rows if per_row else rows * c // vec
    return max(1, min(-(-units // per_step), BLOCKS_PER_SM * sms))


# --- the passes: each its kernel, or with ``plain`` its twin ---------------

def _stats(x: torch.Tensor, mask: Optional[torch.Tensor], plain: bool) -> torch.Tensor:
    """[blocks, 2C + 1] f32 partials of [sum x, sum x^2, n] over the masked rows."""
    if plain:
        flat = x.float()
        if mask is None:
            n = flat.new_full((1,), float(flat.shape[0]))
        else:
            rows = mask.reshape(-1, 1).float()
            flat, n = flat * rows, rows.sum().view(1)
        return torch.cat([flat.sum(0), (flat * x.float()).sum(0), n]).view(1, -1)
    rows, c = x.shape
    nb = blocks(rows, c, x.dtype, "fwd", sm_count(x.device))
    part = torch.empty(nb, 2 * c + 1, dtype=torch.float32, device=x.device)
    _launch("ir_masked_bn_stats", x.data_ptr(), _ptr(mask), part.data_ptr(), rows, c,
            DTYPES[x.dtype], nb, cuda_stream(x))
    return part


def _total(part: torch.Tensor, split: int, plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column sums of ``part`` [blocks, W] in block order, cut at ``split``."""
    if plain:
        t = part.sum(0)
        return t[:split], t[split:]
    nb, width = part.shape
    lo = torch.empty(split, dtype=torch.float32, device=part.device)
    hi = torch.empty(width - split, dtype=torch.float32, device=part.device)
    _launch("ir_masked_bn_total", part.data_ptr(), lo.data_ptr(), hi.data_ptr(), nb, width,
            split, cuda_stream(part))
    return lo, hi


def _finalize(part, weight, running_mean, running_var, momentum, eps, plain: bool):
    """stat [4C + 1] = [scale | mean | 1 / std | var >= 0 | n] from the
    partials' totals; the running statistics move in place."""
    c = weight.shape[0]
    if plain:
        tot = part.sum(0)
        n = tot[2 * c].clamp(min=1.0)
        mean = tot[:c] / n
        var_raw = tot[c:2 * c] / n - mean.square()
        var = var_raw.clamp(min=0.0)
        inv = torch.rsqrt(var + eps)
        m = momentum
        running_mean.copy_((1.0 - m) * running_mean + m * mean)
        running_var.copy_((1.0 - m) * running_var + m * (var * n / (n - 1.0).clamp(min=1.0)))
        return torch.cat([inv * weight, mean, inv, (var_raw >= 0).float(), n.view(1)])
    stat = torch.empty(4 * c + 1, dtype=torch.float32, device=part.device)
    _launch("ir_masked_bn_finalize", part.data_ptr(), weight.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), momentum.data_ptr(),
            stat.data_ptr(), part.shape[0], c, eps, cuda_stream(part))
    return stat


def _unpack(stat: torch.Tensor, c: int):
    """(scale, mean, 1 / std, clamp flag, n) views of ``stat``."""
    return stat[:c], stat[c:2 * c], stat[2 * c:3 * c], stat[3 * c:4 * c], stat[4 * c]


def _apply(x, stat, bias, residual, plain: bool) -> torch.Tensor:
    rows, c = x.shape
    if plain:
        scale, mean = _unpack(stat, c)[:2]
        y = (x.float() - mean) * scale + bias
        if residual is not None:
            y = y + residual.float()
        return torch.relu(y).to(x.dtype)
    y = torch.empty_like(x)
    _launch("ir_masked_bn_apply", x.data_ptr(), _ptr(residual), stat.data_ptr(),
            bias.data_ptr(), y.data_ptr(), rows, c, DTYPES[x.dtype],
            blocks(rows, c, x.dtype, "fwd", sm_count(x.device), per_row=False),
            cuda_stream(x))
    return y


def _grad_and_xh(dy, y, x, stat):
    mean, inv = _unpack(stat, x.shape[1])[1:3]
    return torch.where(y > 0, dy.float(), 0.0), (x.float() - mean) * inv


def _bwd_reduce(dy, y, x, stat, plain: bool) -> torch.Tensor:
    """[blocks, 2C] f32 partials of [sum g, sum g * xh] over every row."""
    rows, c = x.shape
    if plain:
        g, xh = _grad_and_xh(dy, y, x, stat)
        return torch.cat([g.sum(0), (g * xh).sum(0)]).view(1, -1)
    nb = blocks(rows, c, x.dtype, "bwd", sm_count(x.device))
    part = torch.empty(nb, 2 * c, dtype=torch.float32, device=x.device)
    _launch("ir_masked_bn_bwd_reduce", dy.data_ptr(), y.data_ptr(), x.data_ptr(),
            stat.data_ptr(), part.data_ptr(), rows, c, DTYPES[x.dtype], nb, cuda_stream(x))
    return part


def _bwd_apply(dy, y, x, mask, stat, sg, sgx, with_residual: bool, plain: bool):
    """(dx, the residual's gradient or None); ``sg``, ``sgx`` the totals."""
    rows, c = x.shape
    if plain:
        scale, _, _, flag, n = _unpack(stat, c)
        g, xh = _grad_and_xh(dy, y, x, stat)
        m = 1.0 if mask is None else mask.reshape(-1, 1).float()
        dx = scale * (g - m * (sg / n + xh * (sgx / n * flag)))
        return dx.to(x.dtype), (g.to(x.dtype) if with_residual else None)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if with_residual else None
    _launch("ir_masked_bn_bwd_apply", dy.data_ptr(), y.data_ptr(), x.data_ptr(), _ptr(mask),
            stat.data_ptr(), sg.data_ptr(), sgx.data_ptr(), dx.data_ptr(), _ptr(dres), rows, c,
            DTYPES[x.dtype], blocks(rows, c, x.dtype, "bwd", sm_count(x.device), per_row=False),
            cuda_stream(x))
    return dx, dres


def forward_passes(x, mask, weight, bias, residual, running_mean, running_var, momentum,
                   eps: float, plain: bool):
    """(y, stat): the forward's passes, the kernels or (``plain``) the
    twins, on tensors of any device; the sums all-reduced at world size > 1."""
    part = _stats(x, mask, plain)
    if world_size() > 1:
        part = all_reduce_sum(_total(part, part.shape[1], plain)[0]).view(1, -1)
    stat = _finalize(part, weight, running_mean, running_var, momentum, eps, plain)
    return _apply(x, stat, bias, residual, plain), stat


def backward_passes(dy, y, x, mask, stat, with_residual: bool, plain: bool):
    """(dx, dweight, dbias, the residual's gradient or None): the
    backward's passes given the forward's ``y`` and ``stat``; the sums
    all-reduced for dx at world size > 1."""
    c = x.shape[1]
    dbias, dweight = _total(_bwd_reduce(dy, y, x, stat, plain), c, plain)
    sg, sgx = dbias, dweight
    if world_size() > 1:
        sg, sgx = all_reduce_sum(torch.cat([dbias, dweight])).split(c)
    dx, dres = _bwd_apply(dy, y, x, mask, stat, sg, sgx, with_residual, plain)
    return dx, dweight, dbias, dres


class MaskedBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, mask, running_mean, running_var, momentum,
                eps):
        plain = x.device.type == "cpu"
        y, stat = forward_passes(x, mask, weight, bias, residual, running_mean, running_var,
                                 momentum, eps, plain)
        ctx.save_for_backward(x, y, mask, stat)
        ctx.with_residual = residual is not None
        if not plain:
            masked_bn.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, mask, stat = ctx.saved_tensors
        plain = x.device.type == "cpu"
        dx, dweight, dbias, dres = backward_passes(dy.contiguous(), y, x, mask, stat,
                                                   ctx.with_residual, plain)
        if not plain:
            masked_bn.bwd_launches += 1
        return dx, dweight, dbias, dres, None, None, None, None, None


def _check(x, mask, weight, bias, residual, running_mean, running_var, momentum) -> None:
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise ValueError(f"masked_bn: want x [N, C] f32 or bf16, got {tuple(x.shape)} {x.dtype}")
    rows, c = x.shape
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError(f"masked_bn: {name} must be f32 [{c}]")
    if momentum.dtype != torch.float32 or momentum.dim() != 0:
        raise ValueError("masked_bn: momentum must be a 0-d f32 tensor")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (rows,)):
        raise ValueError(f"masked_bn: mask must be bool [{rows}]")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("masked_bn: the residual must have x's shape and dtype")
    tensors = [t for t in (x, mask, weight, bias, residual, running_mean, running_var, momentum)
               if t is not None]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"masked_bn: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("masked_bn: inputs must be contiguous")
    if x.device.type == "cuda":
        if c not in CHANNELS:
            raise ValueError(f"masked_bn: C {c} not in {CHANNELS}")
        if x.data_ptr() % 16 or (residual is not None and residual.data_ptr() % 16):
            raise ValueError("masked_bn: x and the residual must be 16-byte aligned")
    elif x.device.type != "cpu":
        raise ValueError(f"masked_bn: unsupported device {x.device}")


def masked_bn(x: torch.Tensor, mask: Optional[torch.Tensor], weight: torch.Tensor,
              bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
              momentum: torch.Tensor, eps: float,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(BN(x) [+ residual]) in train mode, as the module docstring
    sets out.

    Args:
      x: [N, C] f32 or bf16, contiguous; on a card C in ``CHANNELS``.
      mask: [N] bool (the rows of the statistics) or None (every row).
      weight, bias, running_mean, running_var: f32 [C]; the running
        statistics move in place.
      momentum: 0-d f32 tensor on x's device (read there by the kernel).
      eps: the variance's epsilon.
      residual: [N, C] in x's dtype, added before the ReLU, or None.
    Returns y [N, C] in x's dtype, every row (the padding rows too).
    """
    _check(x, mask, weight, bias, residual, running_mean, running_var, momentum)
    return MaskedBN.apply(x, weight, bias, residual, mask, running_mean, running_var, momentum,
                          float(eps))


masked_bn.launches = masked_bn.bwd_launches = 0
