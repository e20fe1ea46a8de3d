"""PointGroup's train steps' share of the card's peak: the FLOPs of the
steps the window finished (``counts_pointgroup.step_flops`` over the
reference's maps: 2 x Cin x Cout a valid entry of every conv, the heads'
GEMMs, 3x the forward) over the window's time, over 989e12 FLOP/s (one
H100's dense bf16 peak at 700 W), in %."""

from benchmark.counts import PEAK_FLOPS


def read(record):
    if record.get("model") != "pointgroup" or "flops" not in record:
        return None
    return 100.0 * record["flops"] / record["window_s"] / PEAK_FLOPS
