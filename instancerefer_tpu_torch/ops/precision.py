"""Compute-dtype policy, counterpart of ``instancerefer_tpu/ops/precision.py``.

The sparse-conv inputs (activations and weights) and the activations the
encoders store are cast to the compute dtype; accumulation, parameters,
normalization statistics and all head, loss and eval math stay f32.  The
default is f32 passthrough (parity tests); ``set_compute_dtype("bfloat16")``
is the production policy.  This is the port's only process-wide setting.
"""

from __future__ import annotations

from typing import Optional

import torch

_COMPUTE_DTYPE: Optional[torch.dtype] = None  # None => f32 passthrough


def set_compute_dtype(dtype) -> None:
    """dtype: None / 'float32' / torch.float32 for f32; 'bfloat16' or
    torch.bfloat16 for bf16 sparse convs."""
    global _COMPUTE_DTYPE
    if dtype in (None, "float32", torch.float32):
        _COMPUTE_DTYPE = None
    elif dtype in ("bfloat16", torch.bfloat16):
        _COMPUTE_DTYPE = torch.bfloat16
    else:
        raise ValueError(f"unsupported compute dtype {dtype!r}")


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE


def cast_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``cast_in`` gives an input of ``dtype``."""
    return _COMPUTE_DTYPE if _COMPUTE_DTYPE is not None and dtype == torch.float32 else dtype


def cast_in(x: torch.Tensor) -> torch.Tensor:
    """Cast an f32 conv input to the compute dtype (no-op in f32 mode)."""
    dtype = cast_dtype(x.dtype)
    return x if dtype == x.dtype else x.to(dtype)


def rounding_gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Elementwise, how far ``ref`` lies from the values that a store in
    ``got.dtype`` rounds to ``got``: 0 where ``ref`` itself rounds there,
    |got - ref| where ``got`` is f32.  A kernel that sums in f32 and stores
    bf16 holds a tolerance t on its sums iff ``rounding_gap(out, ref) <=
    t`` against an f32 reference (rounding is monotone: out lies between
    ``ref - t`` and ``ref + t``, each rounded)."""
    ref = ref.float()
    if got.dtype == torch.float32:
        return (got - ref).abs()
    inf = torch.full_like(got, float("inf"))
    mid = got.float()
    # the midpoints to the neighbours, exact in f32, bound got's rounding cell
    hi = (mid + torch.nextafter(got, inf).float()) / 2
    lo = (mid + torch.nextafter(got, -inf).float()) / 2
    return (lo - ref).clamp(min=0) + (ref - hi).clamp(min=0)
