"""The sparse-conv kernels' share of their roofline in the train steps of
the traced window: the least time of each K1 / K2 / K3 launch
(``counts.launch_bounds`` over the reference's maps) summed over the
window's steps, over the device time of every sparse-conv kernel there
(``_kernel_names``), in %.  Left out where the window's kernel records
do not agree with the launch counters."""

from benchmark.metrics._kernel_names import is_sparse


def read(record):
    prof = record.get("profile")
    if record["phase"] != "train" or prof is None or not prof["agrees"]:
        return None
    spent = sum(s for name, s in prof["kernel_s"].items() if is_sparse(name))
    return 100.0 * prof["bound_s"] / spent if spent > 0 else None
