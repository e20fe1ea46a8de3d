"""Length-masked stacked GRU (one or two directions), counterpart of
``instancerefer_tpu/ops/gru.py``.

The JAX package reproduces pack/pad semantics with masks inside a
``lax.scan``; here ``torch.nn.GRU`` runs on the packed sequence itself
(cuDNN on the card), which is the reference's own formulation.  Outputs past
each length are zero.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, T] bool, True at t < length."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def packed_gru(gru: nn.GRU, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, T, H * directions], zeros at t >= length.

    A length of 0 (no tokens) yields an all-zero row, as the masked scan
    does; packing needs >= 1, so such rows run one step and are masked.
    """
    t = x.shape[1]
    packed = pack_padded_sequence(
        x, lengths.clamp(min=1).cpu(), batch_first=True, enforce_sorted=False
    )
    out, _ = gru(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
    return out * length_mask(lengths, t)[..., None]
