"""Wrapper of the CUDA sparse-conv gather-GEMM (``csrc/gather_conv.cu``).

The kernel replaces the TPU kernel ``instancerefer_tpu/ops/pallas_conv.py:
_conv_kernel`` (through ``windowed_gather_conv``); the source's header says
what bounds it on the card and what its design does about that.

``gather_conv`` runs the plain twin (``ops/sparse.gather_conv``) for tensors
on the CPU.  A CUDA tensor launches the kernel or raises; there is no
fallback.  ``gather_conv.launches`` counts kernel launches and nothing else.

The source builds at first use with ``nvcc`` into ``instancerefer_tpu_torch/
build/`` (a plain-C shared library loaded with ``ctypes``), keyed by a hash
of the source, so an edited ``.cu`` rebuilds.  ``nvcc`` is found on ``PATH``
or under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from instancerefer_tpu_torch.ops import sparse

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gather_conv.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
COUTS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("gather_conv: nvcc not found on PATH or under CUDA_HOME")
    return path


def build() -> str:
    """Compile the source (if its hash has no library yet); returns the
    library path.  ``nvcc``'s report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``.log``."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"gather_conv_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True,
        )
        with open(lib[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"gather_conv: nvcc failed\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    lib.ir_gather_conv.restype = ctypes.c_int
    lib.ir_gather_conv.argtypes = [
        p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, p,
    ]
    return lib


def _check(feats, nbr, weight, scale, bias):
    dev = feats.device
    if feats.dtype not in _DTYPES:
        raise TypeError(f"gather_conv: feats dtype {feats.dtype} not f32/bf16")
    if weight.dtype != feats.dtype:
        raise TypeError(f"gather_conv: weight {weight.dtype} != feats {feats.dtype}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"gather_conv: nbr dtype {nbr.dtype} is not int32")
    if feats.dim() != 2 or nbr.dim() != 2 or weight.dim() != 3:
        raise ValueError("gather_conv: want feats [V_in, Cin], nbr [V_out, K], weight [K, Cin, Cout]")
    k, cin, cout = weight.shape
    if nbr.shape[1] != k or feats.shape[1] != cin:
        raise ValueError(
            f"gather_conv: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}, "
            f"weight {tuple(weight.shape)} disagree"
        )
    if cout not in COUTS:
        raise ValueError(f"gather_conv: Cout {cout} not in {COUTS}")
    if (scale is None) != (bias is None):
        raise ValueError("gather_conv: scale and bias come together")
    tensors = [feats, nbr, weight]
    for t in (scale, bias):
        if t is not None:
            if t.dtype != torch.float32 or t.shape != (cout,):
                raise ValueError("gather_conv: scale/bias must be f32 [Cout]")
            tensors.append(t)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"gather_conv: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("gather_conv: inputs must be contiguous")


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
      feats:  [V_in, Cin] f32 or bf16, contiguous.
      nbr:    [V_out, K] int32 rows of ``feats`` (all < V_in), -1 = empty.
      weight: [K, Cin, Cout] in ``feats.dtype``; Cout in {32, 64, 128}.
      scale/bias: optional [Cout] f32 epilogue (folded eval BatchNorm).
    Returns [V_out, Cout] in ``feats.dtype``; accumulation is f32.
    """
    _check(feats, nbr, weight, scale, bias)
    if feats.device.type == "cpu":
        return sparse.gather_conv(feats, nbr, weight, scale, bias, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"gather_conv: unsupported device {feats.device}")
    k, cin, cout = weight.shape
    v_out = nbr.shape[0]
    out = torch.empty(v_out, cout, dtype=feats.dtype, device=feats.device)
    if v_out == 0:
        return out
    rc = _library().ir_gather_conv(
        feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), v_out, k, cin, cout, int(relu), _DTYPES[feats.dtype],
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gather_conv: kernel launch failed with CUDA error {rc}")
    gather_conv.launches += 1
    return out


gather_conv.launches = 0
