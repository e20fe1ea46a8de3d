"""The benchmark's own counts of the work a step needs, from the maps the
plain reference builds (``reference/batch.conv_shapes``), never from the
program's: so the same work reads the same count whatever implements it.

* FLOPs (``step_flops``): the port's ``scripts/bench.py`` terms, copied:
  2 x Cin x Cout a valid map entry of every sparse conv, its coarse dense
  terms (the BEV head, the GRU, the word projection), and 3x the forward
  for a train step.
* The least time of each sparse-conv kernel launch (``launch_bounds``):
  the port's ``scripts/step_ab.shape_bounds`` arithmetic, copied (used by
  ``scripts/conv_bytes.py``): the valid entries' FLOPs (x2 for K2's two
  products) over the peak, or the bytes the function must move over the
  peak bandwidth, the larger: bf16 rows and weights read once, the int32
  map, bf16 out of K1, f32 dX and dW out of the backward kernels.  Rows
  here are the batch's real voxels.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_FLOPS = 989e12  # one H100 SXM, dense bf16, at 700 W
PEAK_BYTES_S = 3.35e12  # its HBM3
# the launches of a train step: each conv's forward (K1); backward: a
# stem's dW (K3), a down's dX (K1 over the inverse map) and dW (K3), a
# residual conv's dX and dW (K2)
BACKWARD = {"stem": ("K3",), "down": ("K1 dX", "K3"), "residual": ("K2",)}


def dense_flops(batch: int, scene_cap_last: int, max_tokens: int) -> float:
    """``bench.py``'s coarse dense terms of one forward."""
    total = 2 * batch * scene_cap_last * 128 * 128
    total += 2 * batch * 13 * 23 * 9 * 128 * 128
    total += 2 * batch * 11 * 21 * 9 * 128 * 128
    total += 2 * batch * max_tokens * 2 * 2 * (256 * 384 + 128 * 384)
    total += 2 * batch * max_tokens * (300 * 256 + 256 * 256)
    return total


def step_flops(shapes: List[tuple], phase: str, batch: int, scene_cap_last: int,
               max_tokens: int) -> float:
    """One step's FLOPs over a batch's conv shapes (train: 3x the forward)."""
    forward = sum(2 * nnz * cin * cout for _, nnz, _, _, _, cin, cout in shapes)
    forward += dense_flops(batch, scene_cap_last, max_tokens)
    return forward * (3 if phase == "train" else 1)


def bound_ms(kernel: str, nnz: int, v_in: int, v_out: int, k: int, cin: int, cout: int) -> float:
    """The least ms of one launch (``step_ab.shape_bounds``): ``kernel``
    "K1" (rows ``v_in`` x Cin gathered into ``v_out`` x Cout), "K1 dX"
    (over the inverse map: ``v_in`` g rows of width Cin into ``v_out`` f32
    dX rows of width Cout), "K2" (x and g of ``v_out`` rows) or "K3"."""
    flops = 2 * nnz * cin * cout * (2 if kernel == "K2" else 1)
    nb = v_out * k * 4  # the map
    if kernel == "K1":
        nb += 2 * (v_in * cin + k * cin * cout + v_out * cout) + 8 * cout
    elif kernel == "K1 dX":
        nb += 2 * (v_in * cin + k * cin * cout) + 4 * v_out * cout
    elif kernel == "K2":
        nb += 2 * (v_out * (cin + cout) + k * cin * cout) + 4 * (v_out * cin + k * cin * cout)
    else:
        nb += 2 * (v_in * cin + v_out * cout) + 4 * k * cin * cout
    return max(flops / PEAK_FLOPS, nb / PEAK_BYTES_S) * 1e3


def launch_bounds(shapes: List[tuple], phase: str) -> List[Tuple[str, float]]:
    """(kernel, least ms) of every sparse-conv launch of one step."""
    out = []
    for kind, nnz, v_in, v_out, k, cin, cout in shapes:
        out.append(("K1", bound_ms("K1", nnz, v_in, v_out, k, cin, cout)))
        if phase != "train":
            continue
        for kernel in BACKWARD[kind]:
            if kernel == "K1 dX":  # the inverse map: a row of the stage before per entry
                out.append((kernel, bound_ms(kernel, nnz, v_out, v_in, 8, cout, cin)))
            else:
                out.append((kernel, bound_ms(kernel, nnz, v_in, v_out, k, cin, cout)))
    return out
