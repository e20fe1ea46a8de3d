"""The sparse-conv kernels' share of their roofline in PointGroup's train
steps of the traced window: the least time of each launch of the U-Net
(``counts_pointgroup.launch_bounds`` over the reference's maps: K1, K2,
K3, the downs' dX and the inverse convs' three kernels) summed over the
window's steps, over the device time of every sparse-conv kernel there
(``_kernel_names``, and the inverse convs' ``up_*_tc_kernel``), in %.
Left out where the window's kernel records do not agree with the launch
counters."""

import re

from benchmark.metrics._kernel_names import is_sparse

UP = re.compile(r"up_(fwd|dgrad|wgrad)_tc_kernel")


def read(record):
    prof = record.get("profile")
    if record.get("model") != "pointgroup" or prof is None or not prof["agrees"]:
        return None
    spent = sum(s for name, s in prof["kernel_s"].items() if is_sparse(name) or UP.search(name))
    return 100.0 * prof["bound_s"] / spent if spent > 0 else None
