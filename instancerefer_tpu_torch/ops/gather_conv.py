"""Build of the CUDA sources and the wrapper of the gather-GEMM kernel (K1,
``csrc/gather_conv.cu``).

The kernel replaces the TPU kernel ``instancerefer_tpu/ops/pallas_conv.py:
_conv_kernel`` (through ``windowed_gather_conv``); the source's header says
what bounds it on the card and what its design does about that.

``route`` picks the path of a call from the device, the input type and Cin
alone: the plain twin (``ops/sparse.gather_conv``) for tensors on the CPU;
on a card, for bf16, the tensor-core kernel for Cin in ``TC_CINS`` (under
the tile plan ``tc_plan`` picks from the shape and the card's SM count:
64-row tiles, a tile's offsets split over a cluster of 2 or 4 blocks at the
small stages; ``check_plan`` raises on a plan the C entry is not built
for) and the stem kernel for any other Cin (the stems, K = 27: 7 by default, 10 with
``use_normal``, 135 with ``use_multiview``, 6 in PointGroup); the FMA kernel for f32.  The
output takes the input's type.  A CUDA tensor launches a kernel or raises; there is no
fallback.

The tensor-core kernels are instantiated for the (Cin, Cout) pairs of the
configurations' convs (``csrc/sparse_conv_tc.cuh`` keeps the same lists):
``IR_PAIRS``, InstanceRefer's encoders at {32, 64, 128}; ``PG_SUBM_PAIRS``
and ``PG_DOWN_PAIRS``, PointGroup's U-Net at m = 16 (its submanifold convs
c -> c and 2c -> c, its downs c -> c + 16; the inverse convs take the
downs' pairs).  ``K1_PAIRS``, ``K2_PAIRS`` and ``K3_PAIRS`` say which pairs
each kernel takes; ``check_pair`` raises on any other.  ``gather_conv.launches`` counts
kernel launches and nothing else, and ``gather_conv.stem_launches`` those
of the stem kernel among them.

The stem kernels (K1 here, K3 in ``ops/conv_bwd.py``) take their depth from
the im2col of a row: 27 neighbours of ``stem_channels(Cin)`` channels each
(Cin rounded up to 8, a 16-byte row), padded to a multiple of 16.  They
read only x zero-padded to those channels: ``pad_channels`` makes that copy
in one pass, and the stems' input takes it in place of the cast to bf16
(``ops/sparse_conv.stem_input``).  ``stem_im2col`` and ``stem_weight``
write the kernels' layout in PyTorch, and ``stem_dw`` reads dW out of it
(the tests hold them against the plain twins).

``build()`` compiles every ``.cu`` source under ``csrc/`` with ``nvcc``, one
process per source and all at once, into ``instancerefer_tpu_torch/build/``
(plain-C shared libraries loaded with ``ctypes``).  The libraries are keyed
by a hash of everything under ``csrc/`` and the flags, so an edited source or
header rebuilds; each is written to a temporary file and moved into place.
``nvcc`` is found on ``PATH`` or under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).  The build passes ``STEM_DW_BLOCK`` to the stem K3's
source, which holds it to its warps and tiles at compile time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, NamedTuple, Optional

import torch

from instancerefer_tpu_torch.ops import sparse

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
STEM_DW_BLOCK = 768  # depth columns of a stem K3 block (csrc/sparse_conv_stem.cuh's DB)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DIRSC_STEM_DW_BLOCK={STEM_DW_BLOCK}",
)
COUTS = (32, 64, 128)  # the FMA kernels' (f32) output widths
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
IR_PAIRS = tuple((a, b) for a in COUTS for b in COUTS)
PG_SUBM_PAIRS = ((16, 16), (48, 48), (80, 80), (96, 96), (112, 112), (32, 16), (96, 48),
                 (160, 80), (192, 96))
PG_DOWN_PAIRS = ((16, 32), (32, 48), (48, 64), (64, 80), (80, 96), (96, 112))
# (Cin, Cout) of each tensor-core kernel: K1, K2 (submanifold backward), K3
# (the downs' dW over lists, and the downs' dX over the same lists)
K1_PAIRS = IR_PAIRS + PG_SUBM_PAIRS + PG_DOWN_PAIRS
K2_PAIRS = IR_PAIRS + PG_SUBM_PAIRS
K3_PAIRS = IR_PAIRS + PG_DOWN_PAIRS
TC_WIDTHS = COUTS  # InstanceRefer's widths, whose every pair each kernel takes
# Cin the tensor-core kernels take (any other Cin is a stem)
TC_CINS = tuple(sorted({c for pair in K1_PAIRS for c in pair}))
STEM_K = 27  # the stem kernels' map: the 3^3 submanifold conv
# K1's C entry by route
ENTRY = {"fma": "ir_gather_conv", "tensor_core": "ir_gather_conv_tc",
         "stem_wide": "ir_gather_conv_stem_wide"}


def route(dtype: torch.dtype, cin: int, device) -> str:
    """``"twin"`` on the CPU; on a card, for bf16 inputs,
    ``"tensor_core"`` with ``cin`` in ``TC_CINS`` and ``"stem_wide"``
    with any other ``cin``; ``"fma"`` for f32 (InstanceRefer's widths
    alone)."""
    if torch.device(device).type == "cpu":
        return "twin"
    if dtype != torch.bfloat16:
        return "fma"
    return "tensor_core" if cin in TC_CINS else "stem_wide"


def stem_channels(cin: int) -> int:
    """The channels of a row in the stem kernels' im2col: ``cin`` rounded
    up to 8, 16 bytes (7 -> 8, 10 -> 16, 135 -> 136)."""
    return -(-cin // 8) * 8


def stem_block_n(cout: int) -> int:
    """Output (K1) or g (K3) columns a block of the stem kernels takes: 32,
    or 16 where Cout is no multiple of 32 (csrc/sparse_conv_stem.cuh's
    ``block_n``)."""
    return 32 if cout % 32 == 0 else 16


def stem_depth(cin: int) -> int:
    """The stem kernels' depth: ``STEM_K * stem_channels(cin)`` rounded up
    to a k-step of 16 (27 x 8 = 216 -> 224 at Cin = 7, 27 x 136 = 3672 ->
    3680 at 135)."""
    return -(-STEM_K * stem_channels(cin) // 16) * 16


def stem_depth_blocks(cin: int) -> int:
    """The stem K3's blocks along that depth (1 at Cin = 7 and 10, 5 at
    135): g and the map are read once per block."""
    return -(-stem_depth(cin) // STEM_DW_BLOCK)


def pad_channels(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [V, Cin] as the stem kernels read it, in one pass: a
    contiguous [V, stem_channels(Cin)] copy in ``dtype`` (default
    ``x.dtype``) whose channels past Cin are zero."""
    v, cin = x.shape
    out = torch.empty(v, stem_channels(cin), dtype=dtype or x.dtype, device=x.device)
    out[:, :cin] = x
    out[:, cin:] = 0
    return out


def stem_im2col(feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """[V_out, stem_depth(Cin)] f32: row v holds feats[nbr[v, k]] for
    k = 0..26 side by side, each padded to ``stem_channels(Cin)``
    (column k * cp + c; zeros for -1 and past Cin), then zero columns: the
    stem kernels' tile, for every row."""
    cin = feats.shape[1]
    table, safe = sparse.gather_table(feats, nbr)
    rows = torch.nn.functional.pad(table, (0, stem_channels(cin) - cin))
    cols = rows[safe].reshape(nbr.shape[0], -1)
    return torch.nn.functional.pad(cols, (0, stem_depth(cin) - cols.shape[1]))


def stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """[stem_depth(Cin), Cout] f32: W [27, Cin, Cout] as stored, row
    k * cp + c (cp = ``stem_channels(Cin)``), zero rows for c >= Cin and
    past the 27 offsets.  ``stem_im2col(x, nbr) @ stem_weight(w)`` is the
    conv."""
    cin, cout = weight.shape[1:]
    rows = torch.nn.functional.pad(weight.float(), (0, 0, 0, stem_channels(cin) - cin))
    flat = rows.reshape(-1, cout)
    return torch.nn.functional.pad(flat, (0, 0, 0, stem_depth(cin) - flat.shape[0]))


def stem_dw(product: torch.Tensor, cin: int) -> torch.Tensor:
    """dW [27, Cin, Cout] from ``stem_im2col(x, nbr).T @ g`` [stem_depth(Cin),
    Cout]: row k * cp + c is dW[k, c]; the rows of padding channels and
    depth are dropped, as the kernels never write them."""
    cp = stem_channels(cin)
    return product[:STEM_K * cp].reshape(STEM_K, cp, -1)[:, :cin]


def check_stem(name: str, k: int, *tensors: torch.Tensor) -> None:
    """What the stem kernels take: the 27-offset map and 16-byte aligned
    ``tensors`` (the ones they copy with 16-byte ``cp.async``)."""
    if k != STEM_K:
        raise ValueError(f"{name}: the stem kernel takes K = {STEM_K} offsets, got {k}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the stem kernel needs 16-byte aligned inputs")


def stem_rows(name: str, feats: torch.Tensor, cin: int, path: str) -> torch.Tensor:
    """``feats`` as route ``path`` reads it, given the conv's ``cin``: the
    stem kernels read only the rows ``pad_channels`` makes, [V,
    stem_channels(Cin)]; the twin reads [V, Cin], or those rows through a
    view of their first Cin channels; the other kernels [V, Cin]."""
    width = feats.shape[1]
    takes = {"stem_wide": (stem_channels(cin),), "twin": (cin, stem_channels(cin))}
    if width not in takes.get(path, (cin,)):
        raise ValueError(f"{name}: feats of {width} channels for a conv of Cin {cin} "
                         f"on route {path!r}")
    return feats[:, :cin] if path == "twin" else feats


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tc(name: str, widths, *tensors: torch.Tensor, pairs=K1_PAIRS) -> None:
    """What the tensor-core kernels take: (Cin, Cout) ``widths``, one of
    ``pairs`` (the kernel's; K1's by default), and 16-byte aligned data
    (their 16-byte ``cp.async`` copies)."""
    if tuple(widths) not in pairs:
        raise ValueError(f"{name}: no tensor-core kernel is built for the widths (Cin, Cout) "
                         f"{tuple(widths)}; built: {sorted(pairs)}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the tensor-core kernel needs 16-byte aligned inputs")


SMEM_LIMIT = 232448  # shared memory one block may take on an H100 (227 KB)
PAD = 8  # bf16 padding of a staged row (csrc/sparse_conv_tc.cuh)
TC_BM = 64  # rows a tile of the tensor-core gather-GEMM
# the (tile height, cluster size) plans csrc/sparse_conv_tc.cuh's gather-GEMM
# is built for; its C entries refuse any other
TC_PLANS = ((64, 1), (64, 2), (64, 4))


class TcPlan(NamedTuple):
    """How the tensor-core gather-GEMM (K1, K2's dX) runs one call: tiles
    of ``bm`` output rows, each taken by a cluster of ``cluster`` blocks, of
    which rank q multiplies the tile's listed offsets q, q + cluster, ...
    (``offsets_per_block`` of them at most); the ranks' sums meet in
    distributed shared memory, added in rank order."""

    bm: int
    cluster: int
    offsets_per_block: int


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def tc_plan(rows: int, k: int, red: int, nout: int, out_dtype: torch.dtype,
            sms: int) -> TcPlan:
    """The plan of a tensor-core gather-GEMM over ``rows`` output rows, a
    ``k``-offset map, reduction width ``red`` (K1's Cin; K2's dX: Cout) and
    output width ``nout``, from the shape and the card's ``sms`` alone, so
    a shape always runs, and sums, the same way on a card.

    64-row tiles; where those of a 3^3 map are no more than twice the SMs
    (the 8192-16384-row stages), the tile's offsets split over a cluster of
    2 blocks, or 4 where they are no more than the SMs (the plan sweep of
    ``scripts/step_ab.py`` measured each choice)."""
    if red not in TC_CINS or nout not in TC_CINS or out_dtype not in DTYPES:
        raise ValueError(f"tc_plan: widths {red} -> {nout} ({out_dtype}) are not the "
                         f"tensor-core kernels'")
    if rows <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"tc_plan: {rows} rows, {k} offsets, {sms} SMs")
    tiles = -(-rows // TC_BM)
    cluster = 1 if k <= 8 else 4 if tiles <= sms else 2 if tiles <= 2 * sms else 1
    return TcPlan(TC_BM, cluster, -(-k // cluster))


def tc_smem_bytes(k: int, red: int, nout: int, mirror: bool = False) -> int:
    """Shared memory a block of the gather-GEMM takes, as
    ``tile_smem_bytes`` in csrc/sparse_conv_tc.cuh computes it (the card
    tests hold the two equal): a ring of 2 steps, each the tile's gathered
    rows [64][red + PAD] and the weight slice ([red][nout + PAD], or
    [nout][red + PAD] with ``mirror``: K2's dX and the inverse convs' dX),
    or the cluster's f32 partials [64][nout + 4] where larger; then the
    [64, k] map tile, a flag a offset (whether any row of the tile has a
    valid index there) and the list of the flagged offsets."""
    w_elems = nout * (red + PAD) if mirror else red * (nout + PAD)
    ring = 2 * (TC_BM * (red + PAD) + w_elems) * 2
    return max(ring, TC_BM * (nout + 4) * 4) + (TC_BM + 2) * k * 4


def check_plan(name: str, plan: TcPlan) -> None:
    """Raise on a plan the C entries are not built for (they refuse it too)."""
    if (plan.bm, plan.cluster) not in TC_PLANS:
        raise ValueError(f"{name}: no tensor-core kernel is built for plan {tuple(plan)[:2]}; "
                         f"built: {TC_PLANS}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def build() -> Dict[str, str]:
    """Compile the sources that have no library for the current hash yet;
    returns {source stem: library path}.  ``nvcc``'s report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    names = sorted(os.listdir(CSRC))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in names:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    libs = {
        n[:-3]: os.path.join(BUILD_DIR, f"{n[:-3]}_{digest}.so") for n in names if n.endswith(".cu")
    }
    todo = {stem: lib for stem, lib in libs.items() if not os.path.exists(lib)}
    if not todo:
        return libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for stem, lib in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs[stem] = (proc, tmp)
        failed = []
        for stem, (proc, tmp) in jobs.items():
            report = proc.communicate()[0]
            with open(todo[stem][:-3] + ".log", "w") as f:
                f.write(report)
            if proc.returncode != 0:
                failed.append(f"{stem}.cu:\n{report}")
            else:
                os.replace(tmp, todo[stem])
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return ctypes.CDLL(build()[stem])


@functools.cache
def _entry(name: str, n_codes: int):
    """``ir_gather_conv{,_tc,_stem_wide}``: the pointers, the rows, 4 ints
    and ``n_codes`` more (the tile plan's two on the tensor-core route)."""
    fn = getattr(library("gather_conv"), name)
    p = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * (4 + n_codes) + [p]
    return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def check_tensors(name: str, *tensors: torch.Tensor) -> None:
    """One device for all, contiguous, and a device the wrapper serves."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_map(name: str, nbr: torch.Tensor, k: Optional[int] = None) -> None:
    """int32 [V, K], with K = ``k`` where given."""
    if nbr.dtype != torch.int32:
        raise TypeError(f"{name}: nbr dtype {nbr.dtype} is not int32")
    if nbr.dim() != 2 or (k is not None and nbr.shape[1] != k):
        raise ValueError(f"{name}: nbr {tuple(nbr.shape)} is not [V, {k or 'K'}]")


def _check(feats, nbr, weight, scale, bias):
    if feats.dtype not in DTYPES:
        raise TypeError(f"gather_conv: feats dtype {feats.dtype} not f32/bf16")
    if weight.dtype != feats.dtype:
        raise TypeError(f"gather_conv: weight {weight.dtype} != feats {feats.dtype}")
    if feats.dim() != 2 or weight.dim() != 3:
        raise ValueError("gather_conv: want feats [V_in, Cin], nbr [V_out, K], weight [K, Cin, Cout]")
    k, cin, cout = weight.shape
    check_map("gather_conv", nbr, k)
    if feats.shape[1] not in (cin, stem_channels(cin)):
        raise ValueError(
            f"gather_conv: feats {tuple(feats.shape)}, weight {tuple(weight.shape)} disagree"
        )
    if cout % 16 or cout <= 0:
        raise ValueError(f"gather_conv: Cout {cout} is not a multiple of 16")
    if (scale is None) != (bias is None):
        raise ValueError("gather_conv: scale and bias come together")
    tensors = [feats, nbr, weight]
    for t in (scale, bias):
        if t is not None:
            if t.dtype != torch.float32 or t.shape != (cout,):
                raise ValueError("gather_conv: scale/bias must be f32 [Cout]")
            tensors.append(t)
    check_tensors("gather_conv", *tensors)


def gather_conv(
    feats: torch.Tensor,
    nbr: torch.Tensor,
    weight: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """out[v] = relu?(sum_k feats[nbr[v, k]] @ weight[k] * scale + bias).

    Args:
      feats:  [V_in, Cin] f32 or bf16, contiguous, any Cin; on a card, bf16
        with Cin outside ``TC_CINS`` (a stem) needs K = 27 and the [V_in,
        stem_channels(Cin)] rows of ``pad_channels`` (a stem's input), which
        the twin takes too.
      nbr:    [V_out, K] int32 rows of ``feats`` (all < V_in), -1 = empty.
      weight: [K, Cin, Cout] in ``feats.dtype``; (Cin, Cout) one of
        ``K1_PAIRS`` on the tensor-core route, Cout in {32, 64, 128} on the
        FMA route, a multiple of 16 at a stem.
      scale/bias: optional [Cout] f32 epilogue (folded eval BatchNorm).
    Returns [V_out, Cout] in ``feats.dtype``; accumulation is f32.
    """
    _check(feats, nbr, weight, scale, bias)
    k, cin, cout = weight.shape
    path = route(feats.dtype, cin, feats.device)
    feats = stem_rows("gather_conv", feats, cin, path)
    if path == "twin":
        return sparse.gather_conv(feats, nbr, weight, scale, bias, relu)
    if path == "tensor_core":
        check_tc("gather_conv", (cin, cout), feats, weight)
    elif path == "stem_wide":
        check_stem("gather_conv", k, feats, weight)
    elif path == "fma" and cout not in COUTS:
        raise ValueError(f"gather_conv: the FMA kernel takes Cout in {COUTS}, got {cout}")
    v_out = nbr.shape[0]
    out = torch.empty(v_out, cout, dtype=feats.dtype, device=feats.device)
    if v_out == 0:
        return out
    args = [
        feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), v_out, k, cin, cout, int(relu),
    ]
    codes = []
    if path == "tensor_core":
        plan = tc_plan(v_out, k, cin, cout, feats.dtype, sm_count(feats.device))
        check_plan("gather_conv", plan)
        codes = [plan.bm, plan.cluster]
    fn = _entry(ENTRY[path], len(codes))
    check_launch("gather_conv", fn(*args, *codes, cuda_stream(feats)))
    gather_conv.launches += 1
    gather_conv.stem_launches += path == "stem_wide"
    return out


gather_conv.launches = gather_conv.stem_launches = 0
