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


def cast_in(x: torch.Tensor) -> torch.Tensor:
    """Cast an f32 conv input to the compute dtype (no-op in f32 mode)."""
    if _COMPUTE_DTYPE is not None and x.dtype == torch.float32:
        return x.to(_COMPUTE_DTYPE)
    return x
