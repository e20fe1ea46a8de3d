"""Differentiable sparse convs: ``torch.autograd.Function``s over the kernels.

Counterparts of the JAX package's custom VJPs ``pallas_conv.banded_subm_conv``
(``_banded_fwd``/``_banded_bwd``, ``instancerefer_tpu/ops/pallas_conv.py:
696-817``) and ``ops/sparse.down_gather_conv`` (``_down_conv_banded_*``,
``instancerefer_tpu/ops/sparse.py:275-344``):

* ``subm_conv``: forward K1 with no epilogue, stored in the compute dtype;
  backward K2 (dX and dW), or with ``grad_input=False`` (the stems, whose
  input is a detached leaf) K3 and a zero dX.
* ``down_conv``: forward K1 over ``down``; dX is K1 over the inverse map
  ``up8`` with W^T and an f32 output, dW is K3 over ``down``.

The backwards cast as the JAX ones do: the cotangent to ``cast_in(g.float())``;
dX and dW are computed in f32 and cast to the dtype of the Function's
``feats`` and ``weight``.  ``subm_conv`` receives both already cast to the
compute dtype (so in bf16 its dW is rounded through bf16, as in JAX);
``down_conv`` receives them uncast and casts inside (its dW stays f32).

The kernels' wrappers dispatch by device: CUDA tensors launch the kernels,
CPU tensors run the plain twins.  The Functions live here, not in
``ops/sparse.py``, because the wrappers import the twins from there.
"""

from __future__ import annotations

import torch

from instancerefer_tpu_torch.ops.conv_bwd import conv_dw, subm_conv_bwd
from instancerefer_tpu_torch.ops.gather_conv import gather_conv
from instancerefer_tpu_torch.ops.precision import cast_in


def _cotangent(g: torch.Tensor) -> torch.Tensor:
    return cast_in(g.float()).contiguous()


class SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, nbr, weight, grad_input):
        ctx.save_for_backward(feats, nbr, weight)
        ctx.grad_input = grad_input
        return gather_conv(feats, nbr, weight)

    @staticmethod
    def backward(ctx, g):
        feats, nbr, weight = ctx.saved_tensors
        gc = _cotangent(g)
        if ctx.grad_input:
            dx, dw = subm_conv_bwd(feats, nbr, gc, weight)
            dx = dx.to(feats.dtype)
        else:
            dw = conv_dw(feats, nbr, gc)
            dx = torch.zeros_like(feats) if ctx.needs_input_grad[0] else None
        return dx, None, dw.to(weight.dtype), None


class DownConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, down, up8, weight):
        xc, wc = cast_in(feats).contiguous(), cast_in(weight).contiguous()
        ctx.save_for_backward(xc, down, up8, wc)
        ctx.dtypes = (feats.dtype, weight.dtype)
        return gather_conv(xc, down, wc)

    @staticmethod
    def backward(ctx, g):
        xc, down, up8, wc = ctx.saved_tensors
        feats_dtype, weight_dtype = ctx.dtypes
        gc = _cotangent(g)
        dx = gather_conv(gc, up8, wc.transpose(1, 2).contiguous(), out_dtype=torch.float32)
        dw = conv_dw(xc, down, gc)
        return dx.to(feats_dtype), None, None, dw.to(weight_dtype)


def subm_conv(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
              grad_input: bool = True) -> torch.Tensor:
    """3^3 submanifold conv over the symmetric map ``nbr`` [V, 27]; feats
    and weight are cast to the compute dtype, and so is the output.
    ``grad_input=False`` is valid only where ``feats`` is a leaf whose
    gradient nobody reads (the encoders' stems)."""
    return SubmConv.apply(cast_in(feats).contiguous(), nbr, cast_in(weight).contiguous(),
                          grad_input)


def down_conv(feats: torch.Tensor, down: torch.Tensor, up8: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """2^3 stride-2 conv over ``down`` [V_s, 8] (rows of the previous stage);
    ``up8`` [V_{s-1}, 8] is its inverse (``SparseStage.up8``)."""
    return DownConv.apply(feats, down, up8, weight)
