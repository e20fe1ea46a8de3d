"""Wrappers of the sparse-conv backward kernels.

* ``subm_conv_bwd`` — K2, ``csrc/subm_conv_bwd.cu``: (dX, dW) of the 3^3
  submanifold conv; replaces ``instancerefer_tpu/ops/pallas_conv.py:
  _bwd_fused_kernel`` (through ``windowed_conv_bwd_fused``).
* ``conv_dw`` — K3, ``csrc/conv_dw.cu``: dW of any gather conv; replaces
  ``pallas_conv.py:_dw_kernel`` (through ``windowed_conv_dw``).

Each runs its plain twin (``ops/sparse.subm_conv_bwd`` / ``conv_dw``) for
tensors on the CPU; a CUDA tensor launches a kernel or raises, with no
fallback.  Both take the route ``gather_conv.route`` gives: for bf16 the
tensor-core kernels at Cin in {32, 64, 128} and, for ``conv_dw``, the
stem kernel at any other Cin (K = 27: 7, 10 or 135 channels); the FMA
kernels for f32.  ``<wrapper>.launches`` counts kernel launches and
nothing else (``conv_dw.stem_launches`` those of the stem kernel).  Both
outputs are f32.  dW is a split reduction: the wrapper picks the split
count from the shapes alone, so a given shape always sums in the same
order and repeated launches give bit-identical dW.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from instancerefer_tpu_torch.ops import sparse
from instancerefer_tpu_torch.ops.gather_conv import (
    COUTS, DTYPES, ENTRY, check_launch, check_map, check_stem, check_tc, check_tensors,
    cuda_stream, library, route, stem_depth_blocks, stem_rows,
)

DW_BLOCKS = 512  # about four blocks per SM of an H100
# The fewest rows a split takes, by route: a row tile of the FMA (32) and
# stem (64) kernels; 8 tiles of 64 on the tensor-core (K, split) grid,
# where a split of fewer rows would write a larger partial ([K, Cin, Cout]
# f32: 0.5 MB at a 128 -> 128 down) than the rows it reads.
SPLIT_ROWS = {"fma": 32, "stem_wide": 64, "tensor_core": 512}
# K3's partial dW buffer, splits x [K, Cin, Cout] f32, holds at most this
# many bytes: at Cin = 135 a split's partial is 0.47 MB, and 500 of them
# (233 MB) would cost the sum of the splits more than the dW.
DW_PARTIAL_BYTES = 1 << 24


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dw_splits(rows: int, blocks_per_split: int, path: str, split_bytes: int = 0,
              sms: int = 0) -> int:
    """Row splits of the dW reduction on route ``path``: about
    ``DW_BLOCKS`` blocks in all (on the stem route, whose blocks take a
    whole SM each, at most the card's ``sms``: one wave), at least
    ``SPLIT_ROWS[path]`` rows a split and, where ``split_bytes`` (one
    split's partial) is given, at most ``DW_PARTIAL_BYTES`` of partials.  A
    split spans K blocks on the (K, split) grids and Cout / 32 x the
    depth's blocks on the stem kernel's.  A function of the shapes and the
    card alone, so a shape always sums in one order on a card."""
    if path == "stem_wide" and sms <= 0:
        raise ValueError("dw_splits: the stem route needs the card's SM count")
    blocks = sms // blocks_per_split if path == "stem_wide" else -(-DW_BLOCKS // blocks_per_split)
    splits = min(-(-rows // SPLIT_ROWS[path]), blocks)
    if split_bytes:
        splits = min(splits, DW_PARTIAL_BYTES // split_bytes)
    return max(1, splits)


@functools.cache
def _entry(source: str, name: str, n_args: int, n_ints: int = 5):
    """``name`` of the library built from ``csrc/<source>.cu``: ``n_args``
    pointers, the row count, ``n_ints`` ints and the stream."""
    fn = getattr(library(source), name)
    p = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [p] * n_args + [ctypes.c_longlong] + [ctypes.c_int] * n_ints + [p]
    return fn


def _check_pair(name, feats, g):
    if feats.dtype not in DTYPES:
        raise TypeError(f"{name}: feats dtype {feats.dtype} not f32/bf16")
    if g.dtype != feats.dtype:
        raise TypeError(f"{name}: g {g.dtype} != feats {feats.dtype}")
    if feats.dim() != 2 or g.dim() != 2:
        raise ValueError(f"{name}: want feats [V_in, Cin] and g [V_out, Cout]")
    if g.shape[1] not in COUTS:
        raise ValueError(f"{name}: Cout {g.shape[1]} not in {COUTS}")


def conv_dw(feats: torch.Tensor, nbr: torch.Tensor, g: torch.Tensor,
            cin: Optional[int] = None) -> torch.Tensor:
    """dW[k] = sum_v feats[nbr[v, k]]^T g[v].

    Args:
      feats: [V_in, Cin] f32 or bf16, any Cin; on a card, bf16 with Cin
        outside {32, 64, 128} (a stem) needs K = 27.  Or [V_in,
        stem_channels(Cin)] from ``gather_conv.pad_channels`` (a stem's
        input), with ``cin`` given.
      nbr:   [V_out, K] int32 rows of ``feats`` (all < V_in), -1 = empty.
      g:     [V_out, Cout] in ``feats.dtype``; Cout in {32, 64, 128}.
      cin:   the conv's Cin (default ``feats.shape[1]``).
    Returns [K, Cin, Cout] f32.
    """
    _check_pair("conv_dw", feats, g)
    check_map("conv_dw", nbr)
    if nbr.shape[0] != g.shape[0]:
        raise ValueError(f"conv_dw: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
                         f"g {tuple(g.shape)} disagree")
    check_tensors("conv_dw", feats, nbr, g)
    (v_out, k), cout = nbr.shape, g.shape[1]
    cin = feats.shape[1] if cin is None else cin
    path = route(feats.dtype, cin, feats.device)
    feats = stem_rows("conv_dw", feats, cin, path)
    if path == "twin":
        return sparse.conv_dw(feats, nbr, g)
    if path == "tensor_core":
        check_tc("conv_dw", (cin, cout), feats, g)
    elif path == "stem_wide":
        check_stem("conv_dw", k, feats, g)
    dw = torch.empty(k, cin, cout, dtype=torch.float32, device=feats.device)
    if v_out == 0:
        return dw.zero_()
    if path == "stem_wide":  # a block per 32 columns of g and per depth block
        splits = dw_splits(v_out, cout // 32 * stem_depth_blocks(cin), path, 4 * k * cin * cout,
                           sm_count(feats.device))
    else:
        splits = dw_splits(v_out, k, path, 4 * k * cin * cout)
    partial = torch.empty(splits, k, cin, cout, dtype=torch.float32, device=feats.device)
    args = [feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            v_out, k, cin, cout, splits]
    if path == "fma":
        fn, codes = _entry("conv_dw", "ir_conv_dw", 5), [DTYPES[feats.dtype]]
    else:
        fn, codes = _entry("conv_dw", f"ir_conv_dw_{ENTRY[path]}", 5, 4), []
    check_launch("conv_dw", fn(*args, *codes, cuda_stream(feats)))
    conv_dw.launches += 1
    conv_dw.stem_launches += path == "stem_wide"
    return dw


conv_dw.launches = conv_dw.stem_launches = 0


def subm_conv_bwd(
    feats: torch.Tensor, nbr: torch.Tensor, g: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of the 3^3 submanifold conv over its symmetric map ``nbr``:
    dX[u] = sum_k g[nbr(u,k)] @ W[K-1-k]^T and dW[K-1-k] = sum_u x[u]^T
    g[nbr(u,k)], with the offsets in the host maps' order.

    Args:
      feats:  [V, Cin] the conv's input, f32 or bf16; Cin in {32, 64, 128}.
      nbr:    [V, K] int32, K odd, symmetric under k -> K-1-k.
      g:      [V, Cout] cotangent in ``feats.dtype``; Cout in {32, 64, 128}.
      weight: [K, Cin, Cout] in ``feats.dtype``.
    Returns (dX [V, Cin] f32, dW [K, Cin, Cout] f32).
    """
    _check_pair("subm_conv_bwd", feats, g)
    if weight.dtype != feats.dtype or weight.dim() != 3:
        raise TypeError(f"subm_conv_bwd: weight {weight.dtype} {tuple(weight.shape)}")
    k, cin, cout = weight.shape
    check_map("subm_conv_bwd", nbr, k)
    if k % 2 == 0 or cin not in COUTS or (feats.shape[1], g.shape[1]) != (cin, cout) \
            or not nbr.shape[0] == feats.shape[0] == g.shape[0]:
        raise ValueError(f"subm_conv_bwd: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
                         f"g {tuple(g.shape)}, weight {tuple(weight.shape)} disagree")
    check_tensors("subm_conv_bwd", feats, nbr, g, weight)
    path = route(feats.dtype, cin, feats.device)
    if path == "twin":
        return sparse.subm_conv_bwd(feats, nbr, g, weight)
    if path == "tensor_core":
        check_tc("subm_conv_bwd", (cin, cout), feats, g, weight)
    v = nbr.shape[0]
    dx = torch.empty(v, cin, dtype=torch.float32, device=feats.device)
    dw = torch.empty(k, cin, cout, dtype=torch.float32, device=feats.device)
    if v == 0:
        return dx, dw.zero_()
    splits = dw_splits(v, k, path)
    partial = torch.empty(splits, k, cin, cout, dtype=torch.float32, device=feats.device)
    name = "ir_subm_conv_bwd_tc" if path == "tensor_core" else "ir_subm_conv_bwd"
    check_launch("subm_conv_bwd", _entry("subm_conv_bwd", name, 7, 4)(
        feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), v, k, cin, cout, splits, cuda_stream(feats),
    ))
    subm_conv_bwd.launches += 1
    return dx, dw


subm_conv_bwd.launches = 0
