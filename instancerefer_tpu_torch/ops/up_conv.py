"""Wrappers of the inverse sparse convs' kernels (``csrc/up_conv.cu``):
spconv's ``SparseInverseConv3d``, the up path of PointGroup's U-Net, over
the map of the stride-2 down conv it mirrors.

For a down map ``down`` [V_coarse, 8] (rows of the fine stage, -1 = none;
each fine row named at most once) and a weight W [8, Cin, Cout] (Cin the
coarse width, Cout the fine one):

* ``up_conv``:  out[down[v, k]] = x[v] @ W[k]; a fine row no entry names
  is 0.  The shape of the down conv's dX, over the same per-offset lists
  (``conv_bwd.down_lists``), bf16 out.
* ``up_dx``:    dx[v] = sum_k g[down[v, k]] @ W[k]^T, K1's gather over the
  down map reading W as stored, bf16 out.
* ``up_dw``:    dW[k] = sum_v x[v]^T g[down[v, k]], K3 over the lists, f32.

On the CPU each runs its plain version here (``*_plain``), which the
tests and the card's checks hold the kernels against; on a card, bf16 at
(Cout, Cin) in ``gather_conv.PG_DOWN_PAIRS`` launches the kernels, anything
else raises.  ``up_conv.launches`` counts every launch of the three (a
launch of ``up_dw`` is its kernel and the split sum after it).
"""

from __future__ import annotations

import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse
from instancerefer_tpu_torch.ops.gather_conv import (
    PG_DOWN_PAIRS, check_launch, check_map, check_plan, check_tc, check_tensors, cuda_stream,
    sm_count, tc_plan,
)


def up_conv_plain(x: torch.Tensor, down: torch.Tensor, weight: torch.Tensor,
                  v_fine: int) -> torch.Tensor:
    """``up_conv`` in PyTorch, f32: each coarse row's product with each
    offset's slice, written to the fine row the map names there."""
    out = torch.zeros(v_fine + 1, weight.shape[2], dtype=torch.float32, device=x.device)
    xf, wf = x.float(), weight.float()
    for k in range(down.shape[1]):
        rows = torch.where(down[:, k] >= 0, down[:, k].long(), v_fine)
        out.index_copy_(0, rows, xf @ wf[k])
    return out[:v_fine]


def up_dx_plain(g: torch.Tensor, down: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``up_dx`` in PyTorch, f32: K1's twin over the down map with W^T."""
    return sparse.gather_conv(g.float(), down, weight.float().transpose(1, 2),
                              out_dtype=torch.float32)


def up_dw_plain(g: torch.Tensor, down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``up_dw`` in PyTorch, f32: K3's twin, transposed to W's layout."""
    return sparse.conv_dw(g.float(), down, x.float()).transpose(1, 2).contiguous()


def _check(name: str, x: torch.Tensor, down: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dtype != weight.dtype or weight.dim() != 3 or x.dim() != 2:
        raise ValueError(f"{name}: want x [V, Cin] and weight [8, Cin, Cout] of one dtype, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(weight.shape)} {weight.dtype}")
    check_map(name, down, conv_bwd.LIST_K)


def _on_card(name: str, cin: int, cout: int, *tensors: torch.Tensor) -> bool:
    """Whether the kernels run (a card), after their checks; False on the CPU."""
    if tensors[0].device.type == "cpu":
        return False
    if any(t.dtype not in (torch.bfloat16, torch.int32) for t in tensors):
        raise ValueError(f"{name}: the inverse convs' kernels take bf16")
    check_tc(name, (cout, cin), *tensors, pairs=PG_DOWN_PAIRS)
    return True


def up_conv(x: torch.Tensor, down: torch.Tensor, up8: torch.Tensor, weight: torch.Tensor,
            work: torch.Tensor) -> torch.Tensor:
    """The inverse conv's forward.

    Args:
      x:      [V_coarse, Cin] bf16 (f32 on the CPU).
      down:   [V_coarse, 8] int32, the down map (rows of the fine stage).
      up8:    [V_fine, 8] int32, its inverse (the zero pass reads it).
      weight: [8, Cin, Cout] in x's dtype.
      work:   ``conv_bwd.down_lists(down)``.
    Returns [V_fine, Cout] in x's dtype.
    """
    _check("up_conv", x, down, weight)
    check_map("up_conv", up8, conv_bwd.LIST_K)
    _, cin, cout = weight.shape
    v_coarse, v_fine = down.shape[0], up8.shape[0]
    check_tensors("up_conv", x, down, up8, weight, work)
    if work.numel() != conv_bwd.dw_list_workspace(v_coarse) or x.shape != (v_coarse, cin):
        raise ValueError(f"up_conv: x {tuple(x.shape)}, down {tuple(down.shape)}, workspace "
                         f"{work.numel()} disagree")
    if not _on_card("up_conv", cin, cout, x, down, up8, weight):
        return up_conv_plain(x, down, weight, v_fine).to(x.dtype)
    out = torch.empty(v_fine, cout, dtype=x.dtype, device=x.device)
    if v_fine == 0:
        return out
    splits = conv_bwd.dx_list_splits(max(v_coarse, 1), 8, cout, cin, sm_count(x.device))
    wt = weight.transpose(1, 2).contiguous()
    check_launch("up_conv", conv_bwd._entry("up_conv", "ir_up_conv_tc", 6, 4, 2)(
        x.data_ptr(), down.data_ptr(), up8.data_ptr(), wt.data_ptr(), work.data_ptr(),
        out.data_ptr(), v_coarse, v_fine, 8, cin, cout, splits, cuda_stream(x)))
    up_conv.launches += 1
    return out


def up_dx(g: torch.Tensor, down: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The inverse conv's dX: g [V_fine, Cout] in the weight's dtype ->
    [V_coarse, Cin] in that dtype."""
    _check("up_dx", g, down, weight)
    _, cin, cout = weight.shape
    v_coarse = down.shape[0]
    check_tensors("up_dx", g, down, weight)
    if g.shape[1] != cout:
        raise ValueError(f"up_dx: g {tuple(g.shape)} for a weight {tuple(weight.shape)}")
    if not _on_card("up_dx", cin, cout, g, down, weight):
        return up_dx_plain(g, down, weight).to(g.dtype)
    dx = torch.empty(v_coarse, cin, dtype=g.dtype, device=g.device)
    if v_coarse == 0:
        return dx
    plan = tc_plan(v_coarse, 8, cout, cin, torch.bfloat16, sm_count(g.device))
    check_plan("up_dx", plan)
    check_launch("up_dx", conv_bwd._entry("up_conv", "ir_up_dx_tc", 4, 5, 1)(
        g.data_ptr(), down.data_ptr(), weight.data_ptr(), dx.data_ptr(), v_coarse, 8, cin, cout,
        plan.bm, plan.cluster, cuda_stream(g)))
    up_conv.launches += 1
    return dx


def up_dw(g: torch.Tensor, down: torch.Tensor, x: torch.Tensor, work: torch.Tensor
          ) -> torch.Tensor:
    """The inverse conv's dW: g [V_fine, Cout], x [V_coarse, Cin], both in
    one dtype -> [8, Cin, Cout] f32, over ``work`` (``down_lists(down)``)."""
    if g.dtype != x.dtype or g.dim() != 2 or x.dim() != 2:
        raise ValueError("up_dw: want g [V_fine, Cout] and x [V_coarse, Cin] of one dtype")
    check_map("up_dw", down, conv_bwd.LIST_K)
    (v_coarse, cin), cout = x.shape, g.shape[1]
    check_tensors("up_dw", g, down, x, work)
    if down.shape[0] != v_coarse or work.numel() != conv_bwd.dw_list_workspace(v_coarse):
        raise ValueError(f"up_dw: x {tuple(x.shape)}, down {tuple(down.shape)}, workspace "
                         f"{work.numel()} disagree")
    if not _on_card("up_dw", cin, cout, g, down, x):
        return up_dw_plain(g, down, x)
    dw = torch.empty(8, cin, cout, dtype=torch.float32, device=g.device)
    if v_coarse == 0:
        return dw.zero_()
    splits = conv_bwd.dw_list_splits(v_coarse, 8, cout, cin, sm_count(g.device))
    partial = torch.empty(splits, 8, cin, cout, dtype=torch.float32, device=g.device)
    check_launch("up_dw", conv_bwd._entry("up_conv", "ir_up_dw_tc", 6, 4, 1)(
        g.data_ptr(), down.data_ptr(), x.data_ptr(), work.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), v_coarse, 8, cin, cout, splits, cuda_stream(g)))
    up_conv.launches += 1
    return dw


up_conv.launches = 0
