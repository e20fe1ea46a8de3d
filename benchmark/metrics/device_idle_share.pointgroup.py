"""The share of the traced window's wall time in which the device ran no
kernel, copy or fill (the union of the profiler's device intervals), over
whole passes of PointGroup's train steps, in %.  Left out where the
window's kernel records do not agree with the launch counters (lost
records read as idle)."""


def read(record):
    prof = record.get("profile")
    if record.get("model") != "pointgroup" or prof is None or not prof["agrees"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
