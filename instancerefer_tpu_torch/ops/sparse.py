"""Plain PyTorch sparse ops over padded rows.

Counterparts of ``instancerefer_tpu/ops/sparse.py``.  ``gather_conv``,
``subm_conv_bwd`` and ``conv_dw`` here are the plain twins of the CUDA
kernels K1, K2 and K3 (wrappers in ``ops/gather_conv.py`` and
``ops/conv_bwd.py``): the wrappers run them for CPU tensors, and the tests
and ``chip_smoke.py`` hold the kernels against them.  They import no kernel,
so the wrappers and the autograd Functions (``ops/sparse_conv.py``) can
import them.
"""

from __future__ import annotations

from typing import Optional

import torch


def gather_conv(
    feats: torch.Tensor,
    nbr: torch.Tensor,
    weight: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[v] = sum_k feats[nbr[v, k]] @ weight[k], then the optional
    per-channel ``acc * scale + bias`` and ReLU, stored in ``out_dtype``
    (default ``feats.dtype``).

    Args:
      feats:  [V_in, Cin] bf16 or f32.
      nbr:    [V_out, K] int32 rows of ``feats``, -1 = empty neighbour.
      weight: [K, Cin, Cout] in ``feats.dtype``.
      scale/bias: optional [Cout] f32 (the folded eval BatchNorm).
    Products and the sum over k and Cin are f32, as in the kernel.
    """
    acc = feats.new_zeros(nbr.shape[0], weight.shape[2], dtype=torch.float32)
    table, safe = gather_table(feats, nbr)
    w = weight.float()
    for k in range(nbr.shape[1]):
        acc = acc + table[safe[:, k]] @ w[k]
    if scale is not None:
        acc = acc * scale + bias
    if relu:
        acc = torch.relu(acc)
    return acc.to(feats.dtype if out_dtype is None else out_dtype)


def gather_table(rows: torch.Tensor, nbr: torch.Tensor):
    """(rows as f32 with a zero row appended, nbr with -1 pointing at it):
    ``table[safe]`` gathers ``rows`` by ``nbr``, zeros for -1."""
    table = torch.cat([rows, rows.new_zeros(1, rows.shape[1])]).float()
    return table, torch.where(nbr >= 0, nbr, rows.shape[0]).long()


def subm_conv_bwd(feats, nbr, g, weight):
    """(dX, dW) of the 3^3 submanifold conv over its symmetric map, both
    f32 — the twin of K2 (``pallas_conv.py:_bwd_fused_kernel``):
    dX[u] = sum_k g[nbr(u,k)] @ W[K-1-k]^T, dW[K-1-k] = sum_u x[u]^T
    g[nbr(u,k)].  The mirror K-1-k holds in the host maps' offset order
    (``KERNEL_OFFSETS_3[26-k] == -KERNEL_OFFSETS_3[k]``), the order the
    port stores its kernels in."""
    k = nbr.shape[1]
    table, safe = gather_table(g, nbr)
    x, w = feats.float(), weight.float()
    dx = x.new_zeros(x.shape)
    dw = x.new_empty(weight.shape)
    for i in range(k):
        rows = table[safe[:, i]]
        dx = dx + rows @ w[k - 1 - i].T
        dw[k - 1 - i] = x.T @ rows
    return dx, dw


def conv_dw(feats, nbr, g):
    """dW[k] = sum_v feats[nbr[v,k]]^T g[v], f32 — the twin of K3
    (``pallas_conv.py:_dw_kernel``)."""
    table, safe = gather_table(feats, nbr)
    gf = g.float()
    return torch.stack([table[safe[:, i]].T @ gf for i in range(nbr.shape[1])])


def masked_global_max_pool(
    feats: torch.Tensor, owner: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-owner max over rows (owner -1 = padding); owners with no rows
    pool to 0.  Every shape is fixed by the arguments (no ``bincount``,
    whose length follows the data)."""
    c = feats.shape[1]
    seg = torch.where(owner >= 0, owner, num_segments).long()
    out = feats.new_full((num_segments + 1, c), float("-inf"))
    out = out.scatter_reduce(0, seg[:, None].expand(-1, c), feats, "amax")
    has_rows = torch.zeros(num_segments + 1, dtype=torch.bool, device=feats.device)
    has_rows = has_rows.index_fill(0, seg, True)[:num_segments]
    return torch.where(has_rows[:, None], out[:num_segments], 0.0)


def masked_mean(feats: torch.Tensor, mask: torch.Tensor, axis=0, eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``feats`` over ``axis`` counting only rows where ``mask``
    (broadcast over the trailing dims); 0 where no row counts."""
    m = mask.to(feats.dtype)
    while m.ndim < feats.ndim:
        m = m[..., None]
    return (feats * m).sum(axis) / m.sum(axis).clamp(min=eps)
