"""The benchmark's own counts of the work of a PointGroup train step, from
the maps the plain reference builds (``reference/pointgroup.prepare``),
never from the program's: the same work reads the same count whatever
implements it.

* ``conv_shapes``: every sparse conv of a step as (kind, valid map
  entries, input rows, output rows, offsets, Cin, Cout): the input conv
  (``stem``), the 3^3 submanifold convs (``subm``: two a residual block),
  the 1 x 1 identity branches of the tails' first blocks (``one``, a dense
  GEMM, counted in the FLOPs and in no roofline), the downs (``down``) and
  the inverse convs (``up``).  The rows are the batch's real voxels.
* ``step_flops``: 2 x Cin x Cout a valid entry of every conv, the heads'
  GEMMs (Linear 16 -> 20, 16 -> 16 and 16 -> 3 a point), and 3x that for a
  train step.
* ``launch_bounds``: the least time of each sparse-conv kernel launch of a
  train step, as ``counts.bound_ms`` has it (the valid entries' FLOPs over
  the peak, or the bytes the launch must move over the peak bandwidth, the
  larger), with the inverse convs' three kernels: the forward moves the
  coarse rows and W in and the fine rows out (bf16), as the downs' dX does
  (f32 there); its dX is K1 over the down map (bf16 out); its dW is K3.
  Each launch is tagged ``up`` or not, for ``up_roofline.pointgroup``.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.counts import PEAK_BYTES_S, PEAK_FLOPS, bound_ms

HEAD_MACS = 16 * 20 + 16 * 16 + 16 * 3  # a point's multiply-adds in the heads


def conv_shapes(batch: dict, m: int, levels: int, reps: int) -> List[tuple]:
    """(kind, nnz, v_in, v_out, k, cin, cout) of every conv of the U-Net."""
    lv = batch["levels"]
    rows = [len(x["coords"]) for x in lv]
    nnz3 = [int((x["nbr"] >= 0).sum()) for x in lv]
    out = [("stem", nnz3[0], rows[0], rows[0], 27, 6, m)]
    for s in range(levels):
        c, v = m * (s + 1), rows[s]
        out += [("subm", nnz3[s], v, v, 27, c, c)] * (2 * reps)  # the blocks
        if s + 1 == levels:
            continue
        down = int((lv[s + 1]["down"] >= 0).sum())
        out += [("down", down, v, rows[s + 1], 8, c, c + m),
                ("up", down, rows[s + 1], v, 8, c + m, c),
                # the tails: Res(2c -> c), then Res(c -> c)
                ("subm", nnz3[s], v, v, 27, 2 * c, c), ("one", v, v, v, 1, 2 * c, c),
                ("subm", nnz3[s], v, v, 27, c, c)]
        out += [("subm", nnz3[s], v, v, 27, c, c)] * (2 * (reps - 1))
    return out


def step_flops(shapes: List[tuple], points: int) -> float:
    """A train step's FLOPs: 3x the forward's."""
    forward = sum(2 * nnz * cin * cout for _, nnz, _, _, _, cin, cout in shapes)
    return 3 * (forward + 2 * points * HEAD_MACS)


def _up_ms(kernel: str, nnz: int, v_coarse: int, v_fine: int, cin: int, cout: int) -> float:
    """An inverse conv's launch (Cin the coarse width, Cout the fine)."""
    flops = 2 * nnz * cin * cout
    nb = v_coarse * 8 * 4 + 2 * 8 * cin * cout
    if kernel == "fwd":
        nb += 2 * (v_coarse * cin + v_fine * cout)
    elif kernel == "dgrad":
        nb += 2 * (v_fine * cout + v_coarse * cin)
    else:  # wgrad: both operands in, dW out in f32
        nb += 2 * (v_fine * cout + v_coarse * cin) + 4 * 8 * cin * cout
    return max(flops / PEAK_FLOPS, nb / PEAK_BYTES_S) * 1e3


def launch_bounds(shapes: List[tuple]) -> List[Tuple[str, bool, float]]:
    """(kernel, an inverse conv's, least ms) of every sparse-conv kernel
    launch of a train step."""
    out = []
    for kind, nnz, v_in, v_out, k, cin, cout in shapes:
        if kind == "one":
            continue
        if kind == "up":
            out += [(f"UP {n}", True, _up_ms(n, nnz, v_in, v_out, cin, cout))
                    for n in ("fwd", "dgrad", "wgrad")]
            continue
        out.append(("K1", False, bound_ms("K1", nnz, v_in, v_out, k, cin, cout)))
        if kind == "stem":
            out.append(("K3", False, bound_ms("K3", nnz, v_in, v_out, k, cin, cout)))
        elif kind == "subm":
            out.append(("K2", False, bound_ms("K2", nnz, v_in, v_out, k, cin, cout)))
        else:  # a down: its dX over the lists (an f32 row a fine row), its dW
            out.append(("K1 dX", False, bound_ms("K1 dX", nnz, v_out, v_in, 8, cout, cin)))
            out.append(("K3", False, bound_ms("K3", nnz, v_in, v_out, k, cin, cout)))
    return out
