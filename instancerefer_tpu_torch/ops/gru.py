"""Length-masked stacked GRU (one or two directions), counterpart of
``instancerefer_tpu/ops/gru.py``.

``static_gru`` is what the language module runs: every shape is fixed by the
batch's grid [B, T], nothing is read back to the host, so the step that
holds it can be captured as a CUDA graph.  It follows the JAX package's
masked scan:

* each layer's forward direction runs over the whole grid and is masked
  after; outputs at t < length depend only on inputs at t' <= t, so they
  are exact;
* the reverse direction reverses each row within its own length (a gather
  t -> length - 1 - t for t < length; padding stays in place), runs forward
  with the ``_reverse`` weights, and is reversed back: the first step lands
  on the last valid token, as packing does;
* layer 2 takes layer 1's masked outputs (``nn.GRU`` puts no dropout between
  the language module's layers).

Each direction of each layer is one ``torch.gru`` call of one layer and one
direction over the module's own parameters (cuDNN on the card), so parameter
names and checkpoint keys are those of ``nn.GRU``.  A length of 0 gives a row
of zeros.  ``packed_gru`` runs the module on the packed sequence (the
reference's own formulation, with a device -> host read of the lengths) and
is kept as the plain reference the tests hold ``static_gru`` against.
"""

from __future__ import annotations

import warnings

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


def _one_direction(gru: nn.GRU, x: torch.Tensor, layer: int, suffix: str) -> torch.Tensor:
    """One layer, one direction of ``gru`` over the whole grid of x [B, T, C]."""
    params = [getattr(gru, f"{name}_l{layer}{suffix}")
              for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    h0 = x.new_zeros(1, x.shape[0], gru.hidden_size)
    with warnings.catch_warnings():
        # cuDNN copies one direction's weights out of the module's flat
        # buffer when they do not form a buffer of their own
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        out, _ = torch.gru(x, h0, params, True, 1, 0.0, gru.training, False, True)
    return out


def static_gru(gru: nn.GRU, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, T, H * directions], zeros at t >= length; the
    result of ``packed_gru`` with shapes fixed by [B, T]."""
    t = x.shape[1]
    mask = length_mask(lengths, t)[..., None]
    steps = torch.arange(t, device=x.device)
    # row b's own reversal within its length; padding maps to itself
    rev = torch.where(mask[..., 0], lengths[:, None] - 1 - steps, steps)
    rev = rev[..., None].expand(-1, -1, gru.hidden_size)
    out = x
    for layer in range(gru.num_layers):
        dirs = [_one_direction(gru, out, layer, "")]
        if gru.bidirectional:
            flipped = torch.gather(out, 1, rev[..., :1].expand(-1, -1, out.shape[2]))
            dirs.append(torch.gather(_one_direction(gru, flipped, layer, "_reverse"), 1, rev))
        out = torch.where(mask, torch.cat(dirs, -1), 0.0)
    return out
