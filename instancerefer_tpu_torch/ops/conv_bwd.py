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
count from the shapes alone (``dw_splits``; K2 on tensor cores ``dw_plan``,
with its dX under ``gather_conv.tc_plan``; K3 on tensor cores
``dw_list_splits``), so a given shape always sums in the same order and
repeated launches give bit-identical dW.

K3's tensor-core route (the down convs) runs over per-offset lists of the
map's valid entries: the list pass compacts each column k of the map into
the rows v with nbr[v, k] >= 0, ascending, into an int32 workspace, then
block (k, split) of the dW kernel takes a contiguous range of list k
(``dw_list_ranges``).  The down convs' backward runs the list pass once
(``down_lists``) and hands the workspace to both gradients: to
``conv_dw(..., lists=)`` and to ``down_dx``, the dX over the same lists
(``csrc/sparse_conv_tc.cuh``'s ``dx_list_tc_kernel``, entry in
``csrc/gather_conv.cu``), whose launches count as K1's
(``gather_conv.launches``; ``down_dx.launches`` counts them alone): its
TPU counterpart is ``_conv_kernel`` over the inverse map ``up8``.
``conv_dw`` given no lists runs the pass in its own launch.
``dw_lists`` runs the list pass alone, and ``dw_lists_plain`` is its plain
version (the tests and ``chip_smoke.py`` hold the two equal); its
launches, shared, inside K3's or alone, count in ``dw_lists.launches``.
``down_dx_plain`` is ``down_dx``'s plain version, in the kernel's order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from instancerefer_tpu_torch.ops import sparse
from instancerefer_tpu_torch.ops.gather_conv import (
    COUTS, DTYPES, ENTRY, PAD, SMEM_LIMIT, check_launch, check_map, check_plan, check_stem,
    check_tc, check_tensors, cuda_stream, gather_conv, library, route, sm_count,
    stem_depth_blocks, stem_rows, tc_plan,
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


# K2's dW kernel (csrc/sparse_conv_tc.cuh, dw_group_tc_kernel): rows a
# tile, offsets a block (the C entry refuses another), warps a block
DWG_BR, DW_GROUP, DWG_WARPS = 64, 2, 8
SM_SMEM = 228 * 1024  # shared memory of an H100 SM, 1 KB of it reserved a block


class DwPlan(NamedTuple):
    """How K2's dW runs one call: ``group`` offsets a block (their [Cin,
    Cout] products in registers, the x tile staged once for all), over
    ``splits`` row splits, whose partials the fixed-order sum adds."""

    group: int
    splits: int


def dw_warps(cin: int, cout: int) -> Tuple[int, int]:
    """(WM, WN): the warps along Cin and Cout that split a block's [Cin,
    Cout] products (``DwGroupShape``; 4 of 8 warps at 32 x 32)."""
    wm = min(cin // 16, 4)
    return wm, min(cout // 16, DWG_WARPS // wm)


def dw_group_smem_bytes(cin: int, cout: int) -> int:
    """Shared memory a block of K2's dW takes, as ``dw_group_smem_bytes`` in
    csrc/sparse_conv_tc.cuh computes it (the card tests hold the two
    equal): a ring of up to 4 tiles, each the x tile and ``DW_GROUP``
    gathered g tiles, the tile's map columns and each warp's vote a stage."""
    if cin not in COUTS or cout not in COUTS:
        raise ValueError(f"dw_group_smem_bytes: widths {cin} x {cout} are not the "
                         f"tensor-core kernel's")
    stage = (DWG_BR * (cin + PAD) + DW_GROUP * DWG_BR * (cout + PAD)) * 2
    stages = min(4, (SMEM_LIMIT - 4096) // stage)
    return stages * stage + (DWG_BR * DW_GROUP + stages * DWG_WARPS) * 4


@functools.cache
def dw_plan(rows: int, k: int, cin: int, cout: int, sms: int) -> DwPlan:
    """K2's dW plan from the shape and the card's ``sms`` alone:
    ``DW_GROUP`` offsets a block, and as many row splits as fill the card's
    block slots (the blocks a block's shared memory lets share an SM, times
    ``sms``) over the ceil(k / G) offset groups, at least
    ``SPLIT_ROWS["tensor_core"]`` rows a split and at most
    ``DW_PARTIAL_BYTES`` of partials.  A shape always sums in one order on a
    card."""
    if rows <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"dw_plan: {rows} rows, {k} offsets, {sms} SMs")
    per_sm = max(1, SM_SMEM // (dw_group_smem_bytes(cin, cout) + 1024))
    splits = min(-(-rows // SPLIT_ROWS["tensor_core"]), per_sm * sms // -(-k // DW_GROUP),
                 DW_PARTIAL_BYTES // (4 * k * cin * cout))
    return DwPlan(DW_GROUP, max(1, splits))


# K3's list route (csrc/conv_dw.cu, csrc/sparse_conv_tc.cuh): map rows a
# chunk of the list pass and the offsets it takes (a down map's 8; the C
# entries refuse others); list entries a tile and shared memory a block of
# the dW kernel (dw_list_tc_kernel); the fewest map rows a split takes (a
# list holds at most as many entries as the map has rows)
LIST_CHUNK, LIST_K = 1024, 8
DWL_BR, DWL_SMEM_BUDGET = 64, 113 * 1024
LIST_SPLIT_ROWS = 1024


def dw_list_workspace(v_out: int) -> int:
    """int32 elements of the list pass's workspace, as ``work_ints`` in
    csrc/conv_dw.cu computes it: the lists [8, V_out], the counts [8] and
    each chunk's counts [ceil(V_out / LIST_CHUNK), 8]."""
    return LIST_K * (v_out + 1 + -(-v_out // LIST_CHUNK))


def dw_list_smem_bytes(cin: int, cout: int) -> int:
    """Shared memory a block of K3's list kernel takes, as
    ``dw_list_smem_bytes`` in csrc/sparse_conv_tc.cuh computes it (the card
    tests hold the two equal): a ring of up to 4 slots within
    ``DWL_SMEM_BUDGET``, each the x and g tiles of ``DWL_BR`` entries and
    their row indices."""
    if cin not in COUTS or cout not in COUTS:
        raise ValueError(f"dw_list_smem_bytes: widths {cin} x {cout} are not the "
                         f"tensor-core kernel's")
    slot = DWL_BR * (cin + PAD + cout + PAD) * 2 + 2 * DWL_BR * 4
    return min(4, DWL_SMEM_BUDGET // slot) * slot


def dw_list_blocks(cin: int, cout: int) -> int:
    """Blocks of K3's list kernel an SM holds (its launch bounds): as many
    as the SM's shared memory takes, at most 3."""
    return min(3, SM_SMEM // (dw_list_smem_bytes(cin, cout) + 1024))


@functools.cache
def dw_list_splits(rows: int, k: int, cin: int, cout: int, sms: int) -> int:
    """Splits of each list on K3's tensor-core route, from the shape and
    the card's ``sms`` alone (not from the counts, which live on the card):
    as many as fill the card's block slots (``dw_list_blocks`` a SM) over
    the ``k`` lists, at least ``LIST_SPLIT_ROWS`` map rows a split and at
    most ``DW_PARTIAL_BYTES`` of partials.  A shape always sums in one order
    on a card."""
    if rows <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"dw_list_splits: {rows} rows, {k} offsets, {sms} SMs")
    splits = min(-(-rows // LIST_SPLIT_ROWS), dw_list_blocks(cin, cout) * sms // k,
                 DW_PARTIAL_BYTES // (4 * k * cin * cout))
    return max(1, splits)


def dw_list_ranges(count: int, splits: int) -> list:
    """[(start, end)] of each split's entries of a list of ``count``, as
    ``dw_list_tc_kernel`` computes them on the card: ceil(count / splits)
    entries rounded up to whole tiles of ``DWL_BR``, the last ranges short
    or empty."""
    per = -(-(-(-count // splits)) // DWL_BR) * DWL_BR
    return [(min(count, s * per), min(count, s * per + per)) for s in range(splits)]


def dw_lists_plain(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list pass in PyTorch: (lists [K, V_out] int32, counts [K]
    int32), where lists[k, :counts[k]] are the rows v with nbr[v, k] >= 0
    in ascending order and the rest is -1.  A stable sort per column."""
    valid = (nbr >= 0).T
    counts = valid.sum(1, dtype=torch.int32)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices.to(torch.int32)
    pos = torch.arange(nbr.shape[0], device=nbr.device)
    return torch.where(pos < counts[:, None], order, -1), counts


def dw_lists_into(nbr: torch.Tensor, work: torch.Tensor) -> None:
    """The list pass alone on the card, into ``work`` (``dw_list_workspace``
    int32 elements)."""
    check_launch("dw_lists", _entry("conv_dw", "ir_dw_lists", 2, 1)(
        nbr.data_ptr(), work.data_ptr(), *nbr.shape, cuda_stream(nbr)))
    dw_lists.launches += 1


def dw_lists(nbr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lists, counts) of ``nbr`` [V_out, 8] int32 as ``dw_lists_plain``
    gives them: on the CPU that function, on a card the list pass of K3's
    tensor-core route (-1 written past each count here, not by the pass)."""
    check_map("dw_lists", nbr)
    check_tensors("dw_lists", nbr)
    v_out, k = nbr.shape
    if nbr.device.type == "cpu":
        return dw_lists_plain(nbr)
    if v_out == 0 or k != LIST_K or nbr.data_ptr() % 16:
        raise ValueError(f"dw_lists: the list pass takes a 16-byte aligned map of "
                         f"{LIST_K} offsets and at least one row, got {tuple(nbr.shape)}")
    work = torch.empty(dw_list_workspace(v_out), dtype=torch.int32, device=nbr.device)
    dw_lists_into(nbr, work)
    lists, counts = work[:k * v_out].view(k, v_out), work[k * v_out:k * v_out + k]
    pos = torch.arange(v_out, device=nbr.device)
    return torch.where(pos < counts[:, None], lists, -1), counts


dw_lists.launches = 0


def list_view(work: torch.Tensor, v_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lists [K, V_out], counts [K]): views of a list workspace (on a card
    the entries past each count are unset)."""
    k = LIST_K
    return work[:k * v_out].view(k, v_out), work[k * v_out:k * v_out + k]


def down_lists(nbr: torch.Tensor) -> torch.Tensor:
    """The list pass of a down map ``nbr`` [V_out, 8] int32, run once per
    down backward: the workspace (``dw_list_workspace(V_out)`` int32) that
    ``down_dx`` and ``conv_dw(..., lists=)`` read.  On the CPU
    ``dw_lists_plain`` written in the workspace's layout; on a card the
    list pass (counted in ``dw_lists.launches``), none for a map of no
    rows."""
    check_map("down_lists", nbr, LIST_K)
    check_tensors("down_lists", nbr)
    v_out = nbr.shape[0]
    if nbr.device.type == "cpu" or v_out == 0:
        work = torch.zeros(dw_list_workspace(v_out), dtype=torch.int32, device=nbr.device)
        lists, counts = list_view(work, v_out)
        lists[:], counts[:] = dw_lists_plain(nbr)
        return work
    if nbr.data_ptr() % 16:
        raise ValueError("down_lists: the list pass takes a 16-byte aligned map")
    work = torch.empty(dw_list_workspace(v_out), dtype=torch.int32, device=nbr.device)
    dw_lists_into(nbr, work)
    return work


# The down convs' dX over the lists (csrc/sparse_conv_tc.cuh,
# dx_list_tc_kernel): list entries a tile (its ranges are dw_list_ranges'),
# stages of the ring, up8 rows a block of the zero pass
DXL_BR, DXL_STAGES, DXL_ZERO_ROWS = DWL_BR, 3, 1024


def dx_list_smem_bytes(cin: int, cout: int) -> int:
    """Shared memory a block of the list-driven dX takes, as
    ``dx_list_smem_bytes`` in csrc/sparse_conv_tc.cuh computes it (the card
    tests hold the two equal): W[k] [Cin][Cout] and a ring of ``DXL_STAGES``
    g tiles of ``DXL_BR`` rows, bf16 rows padded by 8; the ring's g row
    indices and the dX rows of ``DXL_STAGES + 1`` tiles."""
    if cin not in COUTS or cout not in COUTS:
        raise ValueError(f"dx_list_smem_bytes: widths {cin} x {cout} are not the "
                         f"tensor-core kernel's")
    return (cin + DXL_STAGES * DXL_BR) * (cout + PAD) * 2 + (2 * DXL_STAGES + 1) * DXL_BR * 4


def dx_list_blocks(cin: int, cout: int) -> int:
    """Blocks of the list-driven dX an SM holds (its launch bounds): as many
    as the SM's shared memory takes, at most 4."""
    return min(4, SM_SMEM // (dx_list_smem_bytes(cin, cout) + 1024))


@functools.cache
def dx_list_splits(rows: int, k: int, cin: int, cout: int, sms: int) -> int:
    """Blocks a list of the list-driven dX, from the shape (``rows``: the
    down map's) and the card's ``sms`` alone: as many as fill the card's
    block slots (``dx_list_blocks`` an SM) over the ``k`` lists, at least
    ``LIST_SPLIT_ROWS`` map rows a block.  Each dX row has one writer, so
    the splits change no sum."""
    if rows <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"dx_list_splits: {rows} rows, {k} offsets, {sms} SMs")
    return max(1, min(-(-rows // LIST_SPLIT_ROWS), dx_list_blocks(cin, cout) * sms // k))


def down_dx_plain(g: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                  lists: torch.Tensor, counts: torch.Tensor, v_in: int,
                  splits: Optional[int] = None) -> torch.Tensor:
    """``down_dx`` in PyTorch: for the entries v of each list k,
    ``index_copy_`` of g[v] @ W[k]^T into rows nbr[v, k] of a zero f32
    [v_in, Cin].  ``lists``/``counts`` as ``dw_lists_plain`` gives them (-1
    past each count).  With ``splits``, in the kernel's order: each split's
    range of each list (``dw_list_ranges``, which reads the counts on the
    host), in tiles of ``DXL_BR`` entries.  Without, each whole list at
    once, its -1 entries into a row past the last that is dropped: no host
    read and no shape from the data (the CPU's ``down_dx``, which the step
    graphs' bodies run)."""
    dx = torch.zeros(v_in + 1, weight.shape[1], dtype=torch.float32, device=g.device)
    gf, wf = g.float(), weight.float()
    for k in range(nbr.shape[1]):
        if splits is None:
            tiles = [lists[k]]
        else:
            tiles = [lists[k, t0:min(p1, t0 + DXL_BR)]
                     for p0, p1 in dw_list_ranges(int(counts[k]), splits)
                     for t0 in range(p0, p1, DXL_BR)]
        for v in tiles:
            v = v.long()
            rows = torch.where(v >= 0, nbr[v.clamp(min=0), k].long(), v_in)
            dx.index_copy_(0, rows, gf[v.clamp(min=0)] @ wf[k].T)
    return dx[:v_in]


def down_dx(g: torch.Tensor, nbr: torch.Tensor, up8: torch.Tensor, weight: torch.Tensor,
            work: torch.Tensor) -> torch.Tensor:
    """dX of the 2^3 stride-2 down conv over ``nbr`` (its ``down`` map):
    dX[nbr[v, k]] = g[v] @ W[k]^T for every valid entry, 0 in the rows no
    entry names.

    Args:
      g:      [V_out, Cout] bf16 (the cotangent); f32 on the CPU.
      nbr:    [V_out, 8] int32 rows of the conv's input, -1 = empty; each
        input row named at most once (a down map).
      up8:    [V_in, 8] int32, the inverse of ``nbr`` (``SparseStage.up8``):
        the kernel's zero pass writes the rows whose entries are all -1.
      weight: [8, Cin, Cout] in ``g.dtype``, as stored.
      work:   ``down_lists(nbr)``.
    Returns [V_in, Cin] f32.  On the CPU ``down_dx_plain``; on a card bf16
    with Cin, Cout in {32, 64, 128} launches ``ir_down_dx_tc``, anything
    else raises.
    """
    if g.dtype not in DTYPES or weight.dtype != g.dtype:
        raise TypeError(f"down_dx: g {g.dtype} and weight {weight.dtype} not one of f32/bf16")
    if g.dim() != 2 or weight.dim() != 3:
        raise ValueError("down_dx: want g [V_out, Cout] and weight [8, Cin, Cout]")
    k, cin, cout = weight.shape
    check_map("down_dx", nbr, LIST_K)
    check_map("down_dx", up8, LIST_K)
    v_out, v_in = nbr.shape[0], up8.shape[0]
    if k != LIST_K or g.shape != (v_out, cout) or work.dtype != torch.int32 \
            or work.numel() != dw_list_workspace(v_out):
        raise ValueError(f"down_dx: g {tuple(g.shape)}, nbr {tuple(nbr.shape)}, weight "
                         f"{tuple(weight.shape)}, workspace {work.numel()} disagree")
    check_tensors("down_dx", g, nbr, up8, weight, work)
    path = route(g.dtype, cin, g.device)
    if path == "twin":
        return down_dx_plain(g, nbr, weight, *list_view(work, v_out), v_in)
    if path != "tensor_core":
        raise ValueError(f"down_dx: the list route takes bf16 at Cin in {COUTS}, got "
                         f"{g.dtype} at Cin {cin}")
    check_tc("down_dx", (cin, cout), g, nbr, up8, weight)
    dx = torch.empty(v_in, cin, dtype=torch.float32, device=g.device)
    if v_in == 0:
        return dx
    splits = dx_list_splits(max(v_out, 1), k, cin, cout, sm_count(g.device))
    check_launch("down_dx", _entry("gather_conv", "ir_down_dx_tc", 6, 4, 2)(
        g.data_ptr(), nbr.data_ptr(), up8.data_ptr(), weight.data_ptr(), work.data_ptr(),
        dx.data_ptr(), v_out, v_in, k, cin, cout, splits, cuda_stream(g)))
    gather_conv.launches += 1
    down_dx.launches += 1
    return dx


down_dx.launches = 0


@functools.cache
def _entry(source: str, name: str, n_args: int, n_ints: int = 5, n_longs: int = 1):
    """``name`` of the library built from ``csrc/<source>.cu``: ``n_args``
    pointers, ``n_longs`` row counts, ``n_ints`` ints and the stream."""
    fn = getattr(library(source), name)
    p = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [p] * n_args + [ctypes.c_longlong] * n_longs + [ctypes.c_int] * n_ints + [p]
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
            cin: Optional[int] = None, lists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW[k] = sum_v feats[nbr[v, k]]^T g[v].

    Args:
      feats: [V_in, Cin] f32 or bf16, any Cin; on a card, bf16 with Cin
        outside {32, 64, 128} (a stem) needs K = 27, and with Cin in {32,
        64, 128} (a down) K = 8 and a 16-byte aligned ``nbr``.  Or [V_in,
        stem_channels(Cin)] from ``gather_conv.pad_channels`` (a stem's
        input), with ``cin`` given.
      nbr:   [V_out, K] int32 rows of ``feats`` (all < V_in), -1 = empty.
      g:     [V_out, Cout] in ``feats.dtype``; Cout in {32, 64, 128}.
      cin:   the conv's Cin (default ``feats.shape[1]``).
      lists: ``down_lists(nbr)``, on the tensor-core route: the list pass
        already run (none here); the other routes read no lists.
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
        check_tc("conv_dw", (cin, cout), feats, g, nbr)
        if k != LIST_K:
            raise ValueError(f"conv_dw: the tensor-core route takes the downs' maps of "
                             f"K = {LIST_K} offsets, got {k}")
        if lists is not None and (lists.dtype != torch.int32 or lists.device != feats.device
                                  or lists.numel() != dw_list_workspace(v_out)):
            raise ValueError(f"conv_dw: lists of {lists.numel()} {lists.dtype} are not the "
                             f"workspace of a {v_out}-row map")
    elif path == "stem_wide":
        check_stem("conv_dw", k, feats, g)
    dw = torch.empty(k, cin, cout, dtype=torch.float32, device=feats.device)
    if v_out == 0:
        return dw.zero_()
    if path == "stem_wide":  # a block per 32 columns of g and per depth block
        splits = dw_splits(v_out, cout // 32 * stem_depth_blocks(cin), path, 4 * k * cin * cout,
                           sm_count(feats.device))
    elif path == "tensor_core":
        splits = dw_list_splits(v_out, k, cin, cout, sm_count(feats.device))
    else:
        splits = dw_splits(v_out, k, path, 4 * k * cin * cout)
    partial = torch.empty(splits, k, cin, cout, dtype=torch.float32, device=feats.device)
    ptrs = [feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr()]
    own_lists = path == "tensor_core" and lists is None  # the list pass runs in this launch
    if path == "tensor_core":  # the list workspace before the partials
        if own_lists:
            lists = torch.empty(dw_list_workspace(v_out), dtype=torch.int32, device=feats.device)
        ptrs.insert(3, lists.data_ptr())
    args = [*ptrs, v_out, k, cin, cout, splits]
    if path == "fma":
        fn, codes = _entry("conv_dw", "ir_conv_dw", 5), [DTYPES[feats.dtype]]
    else:
        suffix = "_lists" if path == "tensor_core" and not own_lists else ""
        fn, codes = _entry("conv_dw", f"ir_conv_dw_{ENTRY[path]}{suffix}", len(ptrs), 4), []
    check_launch("conv_dw", fn(*args, *codes, cuda_stream(feats)))
    conv_dw.launches += 1
    conv_dw.stem_launches += path == "stem_wide"
    dw_lists.launches += own_lists
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
    if path == "tensor_core":  # dX over the mirrored offsets (reduction Cout), then dW
        sms = sm_count(feats.device)
        plan, dwp = tc_plan(v, k, cout, cin, torch.float32, sms), dw_plan(v, k, cin, cout, sms)
        check_plan("subm_conv_bwd", plan)
        splits, name, plans = dwp.splits, "ir_subm_conv_bwd_tc", [plan.bm, plan.cluster, dwp.group]
    else:
        splits, name, plans = dw_splits(v, k, path), "ir_subm_conv_bwd", []
    partial = torch.empty(splits, k, cin, cout, dtype=torch.float32, device=feats.device)
    check_launch("subm_conv_bwd", _entry("subm_conv_bwd", name, 7, 4 + len(plans))(
        feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), weight.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), v, k, cin, cout, splits, *plans, cuda_stream(feats),
    ))
    subm_conv_bwd.launches += 1
    return dx, dw


subm_conv_bwd.launches = 0
