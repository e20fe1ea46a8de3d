"""Device time by kernel from ``torch.profiler``: the sparse-conv kernels by
wrapper (``KERNEL_FAMILIES``, which ``chip_smoke.py`` and
``scripts/step_ab.py`` read too), the rest by coarse class
(``KERNEL_CLASSES``), the busiest kernels and the device's idle gaps over a
window of calls (``device_profile``).  Needs a card; imports the profiler
only when called.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List

# the sparse-conv kernels' names as the profiler reports them, by wrapper:
# the gather-GEMM templates end in MIRROR_T (true: K2's dX; the tensor-core
# one's f32 output and false: K1's dX over up8), the FMA dW one in GATHER_A
# (true: K3); dw_group_tc_kernel is K2's dW; K3's tensor-core route is the
# list pass (dw_list_count_kernel, dw_list_write_kernel) and
# dw_list_tc_kernel; the stem kernels are K1's and K3's;
# sum_partials_kernel serves K2 and K3
KERNEL_FAMILIES = (
    ("K1 dX over up8", re.compile(r"gather_gemm_tc_kernel<float, (\d+, )+false>")),
    ("K1 forward", re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel")),
    ("K2", re.compile(r"gather_gemm(_tc)?_kernel<.*true>|dw_partial_kernel<.*false>"
                      r"|dw_group_tc_kernel")),
    ("K3", re.compile(r"dw_partial_kernel<.*true>|dw_list_\w+_kernel|stem_wide_dw_kernel")),
    ("K2/K3 sum of splits", re.compile(r"sum_partials_kernel")),
)

# every other kernel by what it does, the first pattern that matches its
# name: PyTorch's copies and casts run as elementwise kernels of a copy
# functor (``direct_copy_kernel``, ``bfloat16_copy_kernel``), so they are
# matched before the other elementwise ones
KERNEL_CLASSES = (
    ("copies and casts", re.compile(r"copy_kernel|memcpy|memset", re.I)),
    ("cuDNN RNN (GRU)", re.compile(r"rnn|RNN|GRU|LSTM|elemWise")),
    ("GEMM", re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.I)),
    ("convolution (cuDNN)", re.compile(r"conv|implicit_convolve", re.I)),
    ("reductions", re.compile(r"reduce_kernel|Reduce|norm_kernel|softmax", re.I)),
    ("Adam (multi-tensor)", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("index, scatter, gather", re.compile(r"index|scatter|gather|embedding", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel")),
    ("other", re.compile(r".")),
)


def family_of(name: str):
    """The sparse-conv family of a kernel's name, or None."""
    return next((fam for fam, pat in KERNEL_FAMILIES if pat.search(name)), None)


def class_of(name: str) -> str:
    return next(cls for cls, pat in KERNEL_CLASSES if pat.search(name))


CALL = "device_profile.call"  # the profiler range around each call


def device_profile(fn: Callable[[], object], calls: int, top: int = 25,
                   gaps: int = 10) -> Dict[str, object]:
    """``calls`` calls of ``fn`` under ``torch.profiler`` after one call
    outside it, each ended by ``torch.cuda.synchronize()``; every time is a
    call's (the window's divided by ``calls``): ``wall_ms`` (host clock,
    the profiler's own cost included), ``device_busy_ms`` (the union of
    the device's kernel, memcpy and memset intervals; device-side spans of
    annotated ranges, such as an eager Adam step's, hold kernels counted
    on their own and are left out), ``idle_share`` (1 - busy / wall), the
    device's idle ms inside the calls and between them (where the host
    waits, returns and starts the next call), ``sparse_ms`` by
    ``KERNEL_FAMILIES``, ``dense_ms`` by ``KERNEL_CLASSES``, the ``top``
    busiest kernels ``[name, launches a call, ms a call]`` and the
    ``gaps`` longest idle gaps of the device's timeline ``[ms, kernel
    before, kernel after, between calls]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            with record_function(CALL):
                fn()
                torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    starts = sorted(ev.time_range.start for ev in prof.events()
                    if ev.name == CALL and ev.device_type == DeviceType.CPU)
    events = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                     and not getattr(ev, "is_user_annotation", False)),
                    key=lambda ev: ev.time_range.start)
    sparse = {fam: 0.0 for fam, _ in KERNEL_FAMILIES}
    dense = {cls: 0.0 for cls, _ in KERNEL_CLASSES}
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        ms = ev.time_range.elapsed_us() / 1e3
        fam = family_of(ev.name)
        if fam is not None:
            sparse[fam] += ms
        else:
            dense[class_of(ev.name)] += ms
        entry = by_name.setdefault(ev.name, [0, 0.0])
        entry[0] += 1
        entry[1] += ms
    busy, holes = 0.0, []
    end, before = None, None
    for ev in events:  # the union of the intervals (streams may overlap)
        start, stop = ev.time_range.start, ev.time_range.end
        if end is None or start > end:
            if end is not None:
                between = any(end < s <= start for s in starts)
                holes.append([(start - end) / 1e3, before, ev.name, between])
            busy += (stop - start) / 1e3
            end, before = stop, ev.name
        elif stop > end:
            busy += (stop - end) / 1e3
            end, before = stop, ev.name
    holes.sort(key=lambda h: -h[0])
    names = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    per = 1.0 / calls
    return {
        "calls": calls, "wall_ms": wall * per, "device_busy_ms": busy * per,
        "idle_share": 1.0 - busy / wall if wall else None,
        "idle_within_calls_ms": sum(h[0] for h in holes if not h[3]) * per,
        "idle_between_calls_ms": sum(h[0] for h in holes if h[3]) * per,
        "sparse_ms": {k: v * per for k, v in sparse.items()},
        "dense_ms": {k: v * per for k, v in dense.items()},
        "top_kernels": [[name[:160], n * per, ms * per] for name, (n, ms) in names],
        "idle_gaps": [[ms, a[:100], b[:100], between] for ms, a, b, between in holes[:gaps]],
    }
