"""What the program's own spans recorded over the traced window.  The port's
``utils/profiling.SPAN_LOG`` holds (name, host seconds) of each span that
closed while a profiler recorded, newest last, and every span of the host
step path closes once a step; the traced window is the last profiled, so
its steps' spans are the log's last ones.  A program without that log
reads as nothing."""

import sys

HOST_PATH = ("ir.load", "ir.step", "ir.to_host")  # a step's host path, whole
WAIT = "ir.to_host.wait"  # the read-back, which waits for the step's last kernel


def last_steps(steps: int):
    """{span: host seconds over the log's last ``steps`` of it} for
    ``HOST_PATH`` and ``WAIT``; None where the log lacks any of them."""
    profiling = sys.modules.get("instancerefer_tpu_torch.utils.profiling")
    log = getattr(profiling, "SPAN_LOG", None)
    if log is None or steps <= 0:
        return None
    seen = {name: [] for name in HOST_PATH + (WAIT,)}
    for name, seconds in reversed(log):
        if name in seen and len(seen[name]) < steps:
            seen[name].append(seconds)
    if any(len(v) < steps for v in seen.values()):
        return None
    return {name: sum(v) for name, v in seen.items()}


def host_issue_ms(record, phase: str):
    """Host ms a step on the program's step path in the traced window:
    ``HOST_PATH`` less ``WAIT``."""
    prof = record.get("profile")
    if record["phase"] != phase or prof is None:
        return None
    spent = last_steps(prof["steps"])
    if spent is None:
        return None
    return 1e3 * (sum(spent[name] for name in HOST_PATH) - spent[WAIT]) / prof["steps"]
