"""The inverse convs' share of their roofline in PointGroup's train steps
of the traced window: the least time of each launch of their forward, dX
and dW kernels (``counts_pointgroup.launch_bounds``, the launches tagged
``up``) summed over the window's steps, over the device time of those
kernels there (``up_fwd_tc_kernel``, ``up_dgrad_tc_kernel``,
``up_wgrad_tc_kernel``), in %.  Left out where the window's kernel records
do not agree with the launch counters."""


def read(record):
    prof = record.get("profile")
    if record.get("model") != "pointgroup" or prof is None or not prof["agrees"]:
        return None
    return 100.0 * prof["up_bound_s"] / prof["up_s"] if prof.get("up_s", 0) > 0 else None
