"""Host-side voxelization and kernel-map construction (numpy, C++-accelerated).

The port's copy of ``instancerefer_tpu/ops/voxelize.py``, without the TPU
band metadata (``compute_window_starts``/``compute_offset_window_starts``)
and with one row order: raster, the order the JAX package's ``pallas_conv``
selects (rows sorted by their packed coordinate key, so neighbour indices
stay close and the card's gathers stay local).  Replaces torchsparse's C++
``sparse_quantize`` and the CUDA kernel-map hash build inside ``spnn.Conv3d``
(reference ``lib/dataset.py:228-261``, ``models/attribute_module.py:65-69``).

Coordinate/key scheme: voxel coords are int32 and may be negative (floor of
xyz/voxel_size, matching ``sparse_quantize``).  They are packed into int64 keys
with 14 bits per axis (offset 2^13 ≈ ±8000 voxels ≈ ±160 m at 2 cm) so that
unique/sort/searchsorted give O(N log N) hash-free lookups.

The same routines in C++ (``native/voxelizer.cpp``) are built with ``g++`` at
first import into ``instancerefer_tpu_torch/build/``, keyed by a hash of the
source and flags; each build writes a temporary file and moves it into place,
so concurrent first importers never load a half-written library.  Without a
compiler the numpy path, which gives bit-identical results, is used
(``native_available()`` says which).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "native", "voxelizer.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def native_library_path() -> str:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(NATIVE_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libirvoxelizer_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, NATIVE_SRC, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native():
    path = native_library_path()
    try:
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError) as e:
        warnings.warn(f"native voxelizer unavailable ({e}); using the numpy path", stacklevel=2)
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ir_build_nbr.restype = None
    lib.ir_build_nbr.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.ir_downsample.restype = ctypes.c_int64
    lib.ir_downsample.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p]
    lib.ir_minmax3.restype = None
    lib.ir_minmax3.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32, f32p, f32p]
    lib.ir_invert_down.restype = None
    lib.ir_invert_down.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, i32p, i32p]
    lib.ir_unique_raster.restype = ctypes.c_int64
    lib.ir_unique_raster.argtypes = [i32p, ctypes.c_int64, i64p]
    lib.ir_pyramid.restype = None
    lib.ir_pyramid.argtypes = [
        i32p, i64p, i32p, ctypes.c_int64, ctypes.c_int32, i64p,
        ctypes.c_int32, i32p, i32p, i32p, i32p, i64p,
    ]
    return lib


_NATIVE = _load_native()


def native_available() -> bool:
    return _NATIVE is not None


_COORD_BITS = 14
_COORD_OFF = 1 << (_COORD_BITS - 1)
_COORD_MASK = (1 << _COORD_BITS) - 1

# 3x3x3 kernel offsets in torchsparse's canonical (x-fastest) enumeration order.
# Order only affects which weight slice learns which offset, not the math.
KERNEL_OFFSETS_3 = np.array(
    [[dx, dy, dz] for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
    dtype=np.int32,
)
# 2x2x2 stride-2 offsets: {0, 1} per axis in units of the input stride.
KERNEL_OFFSETS_2 = np.array(
    [[dx, dy, dz] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
    dtype=np.int32,
)


def pack_coords(coords: np.ndarray) -> np.ndarray:
    """Pack int coords [N, 3] into sortable int64 keys.

    Out-of-range coords (beyond ±8191 voxels, i.e. ±160 m at 2 cm) are
    CLIPPED to the boundary — they alias onto boundary voxels rather than
    raising (same policy in the C++ ``pack``)."""
    c = coords.astype(np.int64) + _COORD_OFF
    if c.size and (c.min() < 0 or c.max() > _COORD_MASK):
        c = np.clip(c, 0, _COORD_MASK)
    return (c[:, 0] << (2 * _COORD_BITS)) | (c[:, 1] << _COORD_BITS) | c[:, 2]


def quantize(
    xyz: np.ndarray, feats: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray]:
    """floor-quantize points to voxels, keeping one feature row per voxel,
    rows in raster order (sorted by packed key).

    Mirrors torchsparse 1.2 ``sparse_quantize(pc, feats, quantization_size)``:
    integer coords = floor(xyz / voxel_size); duplicates are dropped keeping
    the first occurrence (reference ``lib/dataset.py:256-261``).
    """
    coords = np.ascontiguousarray(np.floor(xyz / voxel_size), dtype=np.int32)
    if _NATIVE is not None:
        # fused first-occurrence dedup + raster sort (radix, one pass)
        keep = np.empty(len(coords), np.int64)
        m = _NATIVE.ir_unique_raster(coords, len(coords), keep)
        return coords[keep[:m]], feats[keep[:m]]
    # np.unique(return_index) returns the first occurrence per key, and the
    # keys ascending: raster order
    _, first = np.unique(pack_coords(coords), return_index=True)
    return coords[first], feats[first]


def invert_down(down: np.ndarray, v_prev: int):
    """Invert a (non-overlapping) stride-2 map: previous-stage row ->
    (this-stage row, offset), -1 where a row feeds nothing.  Refs >= v_prev
    are dropped, in both paths."""
    if _NATIVE is not None:
        down_c = np.ascontiguousarray(down, dtype=np.int32)
        up_row = np.empty(v_prev, np.int32)
        up_k = np.empty(v_prev, np.int32)
        _NATIVE.ir_invert_down(down_c, down.shape[0], down.shape[1], v_prev, up_row, up_k)
        return up_row, up_k
    up_row = np.full(v_prev, -1, np.int32)
    up_k = np.full(v_prev, -1, np.int32)
    vv, kk = np.nonzero(down >= 0)
    tgt = down[vv, kk]
    ok = tgt < v_prev
    up_row[tgt[ok]] = vv[ok].astype(np.int32)
    up_k[tgt[ok]] = kk[ok].astype(np.int32)
    return up_row, up_k


def point_minmax3(pts: np.ndarray):
    """(min, max) of the first 3 columns of an [n, >=3] float array — the
    xyz extent the scene block carries (reference ``lib/dataset.py:263-299``)."""
    if (
        _NATIVE is not None
        and pts.dtype == np.float32
        and pts.ndim == 2
        and pts.shape[0] > 0
        and pts.shape[1] >= 3
        and pts.flags.c_contiguous
    ):
        mn = np.empty(3, np.float32)
        mx = np.empty(3, np.float32)
        _NATIVE.ir_minmax3(pts, pts.shape[0], pts.shape[1], mn, mx)
        return mn, mx
    x = pts[:, :3]
    return x.min(0).astype(np.float32), x.max(0).astype(np.float32)


def build_up8(up_row: np.ndarray, up_k: np.ndarray) -> np.ndarray:
    """One-hot expansion of an inverted down map: ``up8[u, k] = up_row[u]``
    where ``up_k[u] == k``, else -1 ([v_prev, 8] int32).  The map the down
    conv's dX gathers over."""
    out = np.full((len(up_row), 8), -1, np.int32)
    ok = up_k >= 0
    out[np.nonzero(ok)[0], up_k[ok]] = up_row[ok]
    return out


def _lookup(sorted_keys: np.ndarray, order: np.ndarray, query_keys: np.ndarray) -> np.ndarray:
    """Row index for each query key, -1 if absent.  sorted_keys = keys[order]."""
    if len(sorted_keys) == 0:
        return np.full(query_keys.shape, -1, dtype=np.int32)
    pos_c = np.minimum(np.searchsorted(sorted_keys, query_keys), len(sorted_keys) - 1)
    found = sorted_keys[pos_c] == query_keys
    return np.where(found, order[pos_c].astype(np.int32), np.int32(-1))


def build_nbr3(coords: np.ndarray, stride: int) -> np.ndarray:
    """Submanifold 3^3 neighbor map: nbr3[i, k] = row of coords + offset_k*stride."""
    n = len(coords)
    if n == 0:
        return np.zeros((0, 27), dtype=np.int32)
    if _NATIVE is not None:
        coords = np.ascontiguousarray(coords, dtype=np.int32)
        out = np.empty((n, 27), dtype=np.int32)
        _NATIVE.ir_build_nbr(coords, n, KERNEL_OFFSETS_3, 27, stride, out)
        return out
    keys = pack_coords(coords)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    out = np.empty((n, 27), dtype=np.int32)
    for k, off in enumerate(KERNEL_OFFSETS_3):
        out[:, k] = _lookup(sorted_keys, order, pack_coords(coords + off[None, :] * stride))
    return out


def build_downsample(coords: np.ndarray, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stride-2 downsample: output coords (first-occurrence order) + 2^3
    kernel map into the input rows.

    torchsparse ks=2/stride=2 semantics: output coordinates are the unique
    ``floor(c / (2*stride)) * (2*stride)`` and each output gathers the inputs at
    ``out + {0, stride}^3``.
    """
    if len(coords) == 0:
        return np.zeros((0, 3), dtype=np.int32), np.zeros((0, 8), dtype=np.int32)
    if _NATIVE is not None:
        coords = np.ascontiguousarray(coords, dtype=np.int32)
        out_coords = np.empty((len(coords), 3), np.int32)
        down = np.empty((len(coords), 8), np.int32)
        m = _NATIVE.ir_downsample(coords, len(coords), stride, out_coords, down)
        return out_coords[:m].copy(), down[:m].copy()
    new_stride = stride * 2
    down_coords = (coords // new_stride) * new_stride
    _, first = np.unique(pack_coords(down_coords), return_index=True)
    first.sort()
    out_coords = down_coords[first]
    in_keys = pack_coords(coords)
    order = np.argsort(in_keys, kind="stable")
    sorted_keys = in_keys[order]
    down = np.empty((len(out_coords), 8), dtype=np.int32)
    for k, off in enumerate(KERNEL_OFFSETS_2):
        down[:, k] = _lookup(sorted_keys, order, pack_coords(out_coords + off[None, :] * stride))
    return out_coords, down


@dataclasses.dataclass
class StageArrays:
    """Unpadded per-sample stage, host-side (numpy, local row indices)."""

    coords: np.ndarray  # [n, 3] int32
    owner: np.ndarray  # [n] int32
    nbr3: np.ndarray  # [n, 27] int32 (local)
    down: np.ndarray  # [n, 8] int32 (local, into previous stage), [n,0] on stage 0
    stride: int


def _truncate_stage(stage: StageArrays, cap: int, prev_cap: Optional[int]) -> StageArrays:
    """Enforce a row budget; neighbor refs to dropped rows become -1 (empty)."""
    n = min(len(stage.coords), cap)
    nbr3 = stage.nbr3[:n]
    nbr3 = np.where(nbr3 < cap, nbr3, np.int32(-1))
    down = stage.down[:n]
    if prev_cap is not None and down.shape[1]:
        down = np.where(down < prev_cap, down, np.int32(-1))
    return StageArrays(stage.coords[:n], stage.owner[:n], nbr3, down, stage.stride)


def build_pyramid(
    coords: np.ndarray,
    owner: np.ndarray,
    num_stages: int,
    caps: Optional[Sequence[int]] = None,
) -> List[StageArrays]:
    """Build the full conv pyramid for one sample (or one candidate group),
    every stage in raster order.

    Stage 0 is the input resolution with a 3^3 submanifold map (for the stem,
    reference ``models/basic_blocks.py:63-65``); stages 1..num_stages-1 each
    halve resolution (ks=2 stride=2 downsample conv) and carry a 3^3 map for
    their residual blocks (reference ``models/basic_blocks.py:67-86``).
    Downsampled stages inherit the owner of their first contributing input
    row.
    """
    stages: List[StageArrays] = []
    cur_coords, stride = coords.astype(np.int32), 1
    cur_owner = np.broadcast_to(np.asarray(owner, dtype=np.int32), (len(cur_coords),))
    for s in range(num_stages):
        if s == 0:
            down = np.zeros((len(cur_coords), 0), dtype=np.int32)
        else:
            prev = stages[-1]
            cur_coords, down = build_downsample(prev.coords, prev.stride)
            stride = prev.stride * 2
            # the coordinate-wise floor does not keep raster order: re-sort
            perm = np.argsort(pack_coords(cur_coords), kind="stable")
            cur_coords = cur_coords[perm]
            down = down[perm]
            first_valid = np.argmax(down >= 0, axis=1)
            src = down[np.arange(len(down)), first_valid]
            cur_owner = prev.owner[np.maximum(src, 0)]
        nbr3 = build_nbr3(cur_coords, stride)
        stages.append(StageArrays(cur_coords, cur_owner, nbr3, down, stride))

    if caps is not None:
        stages = [
            _truncate_stage(stage, caps[s], caps[s - 1] if s > 0 else None)
            for s, stage in enumerate(stages)
        ]
    return stages


def concat_stages(groups: List[List[StageArrays]], num_stages: int) -> List[StageArrays]:
    """Concatenate per-candidate pyramids into one per-sample pyramid.

    Local neighbor indices are offset by each group's running row count per
    stage; cross-group neighbors never exist because candidates are distinct
    sparse tensors (reference ``models/attribute_module.py:101``).
    """
    out: List[StageArrays] = []
    for s in range(num_stages):
        coords, owner, nbr3, down = [], [], [], []
        off = 0
        prev_off = 0
        for g in groups:
            st = g[s]
            coords.append(st.coords)
            owner.append(st.owner)
            nbr3.append(np.where(st.nbr3 >= 0, st.nbr3 + off, st.nbr3))
            if s > 0:
                down.append(np.where(st.down >= 0, st.down + prev_off, st.down))
                prev_off += len(g[s - 1].coords)
            off += len(st.coords)
        if not groups:
            coords = [np.zeros((0, 3), dtype=np.int32)]
            owner = [np.zeros((0,), dtype=np.int32)]
            nbr3 = [np.zeros((0, 27), dtype=np.int32)]
            down = [np.zeros((0, 8), dtype=np.int32)]
        stride = groups[0][s].stride if groups else (1 << s)
        n = sum(len(c) for c in coords)
        out.append(
            StageArrays(
                np.concatenate(coords, axis=0),
                np.concatenate(owner, axis=0),
                np.concatenate(nbr3, axis=0),
                np.concatenate(down, axis=0) if s > 0 else np.zeros((n, 0), np.int32),
                stride,
            )
        )
    return out


def build_pyramid_padded(
    group_coords: List[np.ndarray],
    owners: Sequence[int],
    caps: Sequence[int],
) -> Tuple[List[StageArrays], List[int]]:
    """Per-group pyramids -> concatenated per stage -> truncated + padded to
    ``caps``, plus the pre-truncation merged row count per stage (the
    caller's overflow accounting).

    Exactly ``pad_stage(concat_stages([build_pyramid(c, o, S) for ...]), cap,
    prev_cap)`` per stage.  With the native library this is one C call per
    sample pyramid: merge-join neighbor maps over the raster-sorted rows.
    """
    num_stages = len(caps)
    if _NATIVE is not None:
        g = len(group_coords)
        if g:
            flat = np.ascontiguousarray(np.concatenate(group_coords, axis=0), dtype=np.int32)
        else:
            flat = np.zeros((0, 3), np.int32)
        group_off = np.zeros(g + 1, np.int64)
        np.cumsum([len(c) for c in group_coords], out=group_off[1:])
        owners_a = np.asarray(list(owners), np.int32)
        caps_a = np.asarray(list(caps), np.int64)
        total = int(caps_a.sum())
        out_coords = np.empty((total, 3), np.int32)
        out_owner = np.empty(total, np.int32)
        out_nbr3 = np.empty((total, 27), np.int32)
        out_down = np.empty((total, 8), np.int32)
        out_counts = np.empty(num_stages, np.int64)
        _NATIVE.ir_pyramid(
            flat, group_off, owners_a, g, num_stages, caps_a, 1,
            out_coords, out_owner, out_nbr3, out_down, out_counts,
        )
        stages = []
        lo = 0
        for s, cap in enumerate(caps):
            hi = lo + cap
            down = out_down[lo:hi] if s > 0 else np.zeros((cap, 0), np.int32)
            stages.append(
                StageArrays(out_coords[lo:hi], out_owner[lo:hi], out_nbr3[lo:hi], down, 1 << s)
            )
            lo = hi
        return stages, [int(c) for c in out_counts]

    groups = [
        build_pyramid(c, owner=o, num_stages=num_stages) for c, o in zip(group_coords, owners)
    ]
    merged = concat_stages(groups, num_stages)
    counts = [len(merged[s].coords) for s in range(num_stages)]
    stages = [
        pad_stage(merged[s], caps[s], caps[s - 1] if s > 0 else None) for s in range(num_stages)
    ]
    return stages, counts


def pad_stage(stage: StageArrays, cap: int, prev_cap: Optional[int]) -> StageArrays:
    """Pad (or truncate) a per-sample stage to exactly ``cap`` rows."""
    stage = _truncate_stage(stage, cap, prev_cap)
    pad = cap - len(stage.coords)
    if pad == 0:
        return stage
    coords = np.concatenate([stage.coords, np.zeros((pad, 3), np.int32)])
    owner = np.concatenate([stage.owner, np.full((pad,), -1, np.int32)])
    nbr3 = np.concatenate([stage.nbr3, np.full((pad, 27), -1, np.int32)])
    down = np.concatenate([stage.down, np.full((pad, stage.down.shape[1]), -1, np.int32)])
    return StageArrays(coords, owner, nbr3, down, stage.stride)
