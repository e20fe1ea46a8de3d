"""The device trace of a traced run (``--trace 1``): a window of steps
under ``torch.profiler``, read into a record the per-layer metrics
(``metrics/``) take their numbers from.

The arithmetic is a copy of the port's ``utils/profiling.device_profile``:
the device is busy in the union of its kernel, copy and fill intervals
(device-side spans of annotated ranges hold kernels counted on their own
and are left out); idle is the rest of the window's wall time; each gap
is labelled with the host range it fell in (the harness's own ranges:
``load``, ``step``, ``metrics_to_host``).

The profiler loses device records now and then.  A window's sparse-conv
launches, counted by kernel name (``metrics/_kernel_names.LAUNCH_FIRST``),
must equal what the program's launch counters added over it; a window that
disagrees is taken again, up to ``TRIES`` windows.  If none agrees, the
record says why and the metrics that read kernel records are left out.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

TRIES = 3
HOST_RANGES = ("load", "step", "metrics_to_host")


def launches(names: List[str], first: Dict[str, object]) -> Dict[str, int]:
    """Launches by family: the kernels that open one (``LAUNCH_FIRST``)."""
    seen = dict.fromkeys(first, 0)
    for name in names:
        fam = next((f for f, pat in first.items() if pat.search(name)), None)
        if fam is not None:
            seen[fam] += 1
    return seen


def counted(before, after) -> Dict[str, int]:
    """The launch counters' additions by family: (K1, K1 at the stems, K2,
    K3, K3 at the stems, the list pass, the downs' dX) -> K1, K2, K3, L."""
    d = [a - b for a, b in zip(after, before)]
    return {"K1": d[0], "K2": d[2], "K3": d[3], "L": d[5]}


def _window(run: Callable[[Callable[[str], object]], None], counters):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(record_function)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = counters()
    events = prof.events()
    device = sorted(((ev.name, ev.time_range.start, ev.time_range.end) for ev in events
                     if ev.device_type == DeviceType.CUDA
                     and not getattr(ev, "is_user_annotation", False)), key=lambda e: e[1])
    host = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type == DeviceType.CPU and ev.name in HOST_RANGES]
    return {"wall_s": wall, "device": device, "host": host, "counted": counted(before, after)}


def profile(run: Callable[[Callable[[str], object]], None], counters,
            first: Dict[str, object], log: Callable[[str], None]) -> dict:
    """``run(ranges)`` under the profiler until a window's launches agree
    with the counters, at most ``TRIES`` windows; ``ranges(name)`` is a
    context manager that marks a host range.  The record of the agreeing
    window, or of the last with ``agrees`` False and ``why``."""
    for attempt in range(1, TRIES + 1):
        w = _window(run, counters)
        seen = launches([name for name, _, _ in w["device"]], first)
        w["seen"] = seen
        if seen == w["counted"]:
            w["agrees"], w["why"] = True, None
            break
        w["agrees"] = False
        w["why"] = (f"window {attempt} of {TRIES}: the profiler's launches {seen} are not the "
                    f"counters' {w['counted']} ({len(w['device'])} device records kept)")
        log(w["why"])
    return summarize(w)


def summarize(w: dict, top: int = 10) -> dict:
    """Busy seconds (the union of the device intervals), the busiest
    device operations and the longest idle gaps, each labelled by the host
    range it fell in."""
    busy, gaps, end, before = 0.0, [], None, None
    for name, start, stop in w["device"]:
        if end is None or start > end:
            if end is not None:
                gaps.append(((start - end) / 1e6, before, name, (start + end) / 2))
            busy += (stop - start) / 1e6
            end, before = stop, name
        elif stop > end:
            busy += (stop - end) / 1e6
            end, before = stop, name
    by_name: Dict[str, float] = {}
    for name, start, stop in w["device"]:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
    gaps.sort(key=lambda g: -g[0])

    def host_at(t: float) -> str:
        inside = [(stop - start, name) for name, start, stop in w["host"] if start <= t <= stop]
        return min(inside)[1] if inside else "between steps"

    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "agrees": w["agrees"], "why": w["why"], "window_s": w["wall_s"], "busy_s": busy,
        "seen": w["seen"], "counted": w["counted"], "kernel_s": by_name,
        "device_ops": [[name[:160], s] for name, s in ops[:top]],
        "idle_gaps": [[f"{host_at(mid)}: after {a[:60]}, before {b[:60]}", s]
                      for s, a, b, mid in gaps[:top]],
    }

