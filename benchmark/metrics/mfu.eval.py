"""The eval steps' share of the card's peak: the FLOPs of the steps the
window finished (the benchmark's own count over the reference's maps,
``counts.step_flops``) over the window's time, over 989e12 FLOP/s (one
H100's dense bf16 peak at 700 W), in %."""

from benchmark.counts import PEAK_FLOPS


def read(record):
    if record["phase"] != "eval" or record["driver"] != "resident":
        return None
    return 100.0 * record["flops"] / record["window_s"] / PEAK_FLOPS
