"""Differentiable sparse convs: ``torch.autograd.Function``s over the kernels.

Counterparts of the JAX package's custom VJPs ``pallas_conv.banded_subm_conv``
(``_banded_fwd``/``_banded_bwd``, ``instancerefer_tpu/ops/pallas_conv.py:
696-817``) and ``ops/sparse.down_gather_conv`` (``_down_conv_banded_*``,
``instancerefer_tpu/ops/sparse.py:275-344``):

* ``subm_conv``: forward K1 with no epilogue, stored in the compute dtype;
  backward K2 (dX and dW), or with ``grad_input=False`` (the stems, whose
  input is a detached leaf) K3 and a zero dX.  A stem's input comes from
  ``stem_input``: on the card's stem route the same copy that casts it is
  zero-padded to 16-byte rows, the only rows the stem kernels read.
* ``down_conv``: forward K1 over ``down``; backward one list pass of
  ``down`` (``conv_bwd.down_lists``, or the caller's ``lists``) that both
  gradients read: dX (``conv_bwd.down_dx``, the counterpart of K1 over the
  inverse map ``up8`` with W^T, stored in the dtype of the conv's input)
  and dW (K3 over ``down``).  f32 on a card (the FMA kernels, no lists)
  takes K1 over ``up8`` and K3's own route.
* ``inverse_conv``: spconv's ``SparseInverseConv3d`` over a down map
  (PointGroup's up path; ``ops/up_conv``): forward ``up_conv`` over the
  map's lists, backward ``up_dx`` (K1's gather over the map) and ``up_dw``
  (K3 over the same lists), both in the compute dtype; the lists are the
  caller's, one pass a level serving the down conv too.

The backwards give the bits of the JAX ones' casts (the cotangent as
``cast_in(g.float())``; dX and dW summed in f32, then cast to the dtype of
the Function's ``feats`` and ``weight``) with no round trip through f32:
``_cotangent`` takes the cotangent as ``cast_in(g)``, copying only to
round an f32 one or to make one contiguous (``_cotangent.copies`` counts
those, ``_cotangent.copied`` by Function), and the kernels store dX in
the input's dtype, the one rounding of their f32 sums.  ``subm_conv``
receives feats and weight already cast to the compute dtype (so in bf16
its dW is rounded through bf16, as in JAX); ``down_conv`` receives them
uncast and casts inside (its dW stays f32, and so does an f32 input's
dX).

The kernels' wrappers dispatch by device: CUDA tensors launch the kernels,
CPU tensors run the plain twins.  The Functions live here, not in
``ops/sparse.py``, because the wrappers import the twins from there.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from instancerefer_tpu_torch.ops.conv_bwd import conv_dw, down_dx, down_lists, subm_conv_bwd
from instancerefer_tpu_torch.ops.gather_conv import gather_conv, pad_channels, route
from instancerefer_tpu_torch.ops.precision import cast_dtype, cast_in
from instancerefer_tpu_torch.ops.up_conv import up_conv, up_dw, up_dx


def _cotangent(g: torch.Tensor, owner: str) -> torch.Tensor:
    """The cotangent ``g`` of Function ``owner`` as its kernels read it:
    ``cast_in(g)``, contiguous; ``g`` itself where it is both already."""
    gc = cast_in(g).contiguous()
    if gc is not g:
        _cotangent.copies += 1
        _cotangent.copied[owner] += 1
    return gc


_cotangent.copies = 0
_cotangent.copied = collections.Counter()


class SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, nbr, weight, grad_input):
        ctx.save_for_backward(feats, nbr, weight)
        ctx.grad_input = grad_input
        return gather_conv(feats, nbr, weight)

    @staticmethod
    def backward(ctx, g):
        feats, nbr, weight = ctx.saved_tensors
        gc = _cotangent(g, "SubmConv")
        if ctx.grad_input:
            dx, dw = subm_conv_bwd(feats, nbr, gc, weight)
        else:
            dw = conv_dw(feats, nbr, gc, cin=weight.shape[1])
            dx = torch.zeros_like(feats) if ctx.needs_input_grad[0] else None
        return dx, None, dw.to(weight.dtype), None


class DownConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, down, up8, weight, lists):
        xc, wc = cast_in(feats).contiguous(), cast_in(weight).contiguous()
        ctx.save_for_backward(xc, down, up8, wc, lists)
        ctx.dtypes = (feats.dtype, weight.dtype)
        return gather_conv(xc, down, wc)

    @staticmethod
    def backward(ctx, g):
        xc, down, up8, wc, lists = ctx.saved_tensors
        feats_dtype, weight_dtype = ctx.dtypes
        gc = _cotangent(g, "DownConv")
        if route(gc.dtype, wc.shape[1], gc.device) == "fma":
            dx = gather_conv(gc, up8, wc.transpose(1, 2).contiguous())
            dw = conv_dw(xc, down, gc)
        else:
            lists = down_lists(down) if lists is None else lists
            dx = down_dx(gc, down, up8, wc, lists, feats_dtype)
            dw = conv_dw(xc, down, gc, lists=lists)
        return dx.to(feats_dtype), None, None, dw.to(weight_dtype), None


class InverseConv(torch.autograd.Function):
    """out[down[v, k]] = x[v] @ W[k] (``ops/up_conv``), in the compute
    dtype; dX and dW are computed from the cotangent cast as ``_cotangent``
    casts it, dX in the compute dtype and dW in f32, each then cast to the
    dtype of its input."""

    @staticmethod
    def forward(ctx, feats, down, up8, weight, lists):
        xc, wc = cast_in(feats).contiguous(), cast_in(weight).contiguous()
        ctx.save_for_backward(xc, down, wc, lists)
        ctx.dtypes = (feats.dtype, weight.dtype)
        return up_conv(xc, down, up8, wc, lists)

    @staticmethod
    def backward(ctx, g):
        xc, down, wc, lists = ctx.saved_tensors
        feats_dtype, weight_dtype = ctx.dtypes
        gc = _cotangent(g, "InverseConv")
        dx = up_dx(gc, down, wc) if ctx.needs_input_grad[0] else None
        dw = up_dw(gc, down, xc, lists)
        return (None if dx is None else dx.to(feats_dtype)), None, None, dw.to(weight_dtype), None


def stem_input(feats: torch.Tensor) -> torch.Tensor:
    """A stem's input, detached, in one copy: cast to the compute dtype
    and, where the stem takes the stem kernels (bf16 on a card, Cin not
    in ``gather_conv.TC_CINS``), zero-padded to 16-byte rows
    (``gather_conv.pad_channels``)."""
    x, dtype = feats.detach(), cast_dtype(feats.dtype)
    if route(dtype, x.shape[1], x.device) == "stem_wide":
        return pad_channels(x, dtype)
    return cast_in(x).contiguous()


def subm_conv(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
              grad_input: bool = True) -> torch.Tensor:
    """3^3 submanifold conv over the symmetric map ``nbr`` [V, 27]; feats
    and weight are cast to the compute dtype, and so is the output.
    ``grad_input=False`` is valid only where ``feats`` is a leaf whose
    gradient nobody reads (the encoders' stems)."""
    return SubmConv.apply(cast_in(feats).contiguous(), nbr, cast_in(weight).contiguous(),
                          grad_input)


def down_conv(feats: torch.Tensor, down: torch.Tensor, up8: torch.Tensor,
              weight: torch.Tensor, lists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """2^3 stride-2 conv over ``down`` [V_s, 8] (rows of the previous stage);
    ``up8`` [V_{s-1}, 8] is its inverse (``SparseStage.up8``).  ``lists``:
    ``conv_bwd.down_lists(down)`` where the caller has run it (else the
    backward runs it)."""
    return DownConv.apply(feats, down, up8, weight, lists)


def inverse_conv(feats: torch.Tensor, down: torch.Tensor, up8: torch.Tensor,
                 weight: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """The inverse of the 2^3 stride-2 conv over ``down`` [V_s, 8]: feats
    [V_s, Cin] -> [V_{s-1}, Cout], each row of the stage before taking its
    parent's row times its offset's slice of ``weight`` [8, Cin, Cout] (0
    where it has no parent); ``lists`` is ``conv_bwd.down_lists(down)``."""
    return InverseConv.apply(feats, down, up8, weight, lists)
