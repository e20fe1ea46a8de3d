"""The port's tracing: its spans, and device time read from
``torch.profiler``.

* ``span(name, **args)``: a range of the program, ``record_function`` while
  a profiler records and otherwise one shared no-op context.  Its host
  ranges are the profiler's, on the clock of the device's records, so a
  trace's host and device timelines line up.  Every name starts with
  ``ir.``; a step's spans carry its number (``step=``).  While a profiler
  records, each closed span also adds (name, host seconds) to
  ``SPAN_LOG``, for readers that hold no profiler's events.  The spans:

  - the host step path, on every step: ``ir.load`` (``StepGraphs.load``,
    ``Solver._load``) with ``ir.load.sources`` and ``ir.load.copy``
    (``data/host.finish``); ``ir.step`` (``StepGraphs._step``) with
    ``ir.step.mode``, ``ir.step.replay``, ``ir.step.capture`` and
    ``ir.step.clone``; ``ir.to_host`` (``solver.metrics_to_host``) with
    ``ir.to_host.issue`` and ``ir.to_host.wait``;
  - modules, in eager steps and captures (a replay runs no Python):
    ``ir.fwd.lang``, ``ir.fwd.attribute``, ``ir.fwd.relation``,
    ``ir.fwd.scene`` (``InstanceRefer.forward``), ``ir.bn``
    (``MaskedBatchNorm.forward``, and ``.fused``: the encoders' BN with the
    ReLU and residual add after it), and the step bodies' ``ir.loss``,
    ``ir.backward``, ``ir.adam``, ``ir.eval``.

* ``device_profile``: calls of a function under the profiler, each window's
  sparse-conv launches by kernel name (``LAUNCH_FIRST``) held against the
  launch counters and retaken until they agree (``PROFILE_TRIES``): the
  device's busy and idle time, the idle gaps labelled by the innermost span
  the host was in (``idle_by_span``), the sparse-conv kernels by wrapper
  (``KERNEL_FAMILIES``, which ``chip_smoke.py`` and ``scripts/step_ab.py``
  read too) and the rest by class (``KERNEL_CLASSES``).
* ``module_split``: device time of eager calls by the span that launched
  it, a backward kernel charged to the span of the forward op that shares
  its autograd sequence number.

The readers need a card; the profiler's imports are made when called.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd.profiler import record_function

SPAN_PREFIX = "ir."
# (name, host seconds) of each span closed while a profiler recorded, newest last
SPAN_LOG: collections.deque = collections.deque(maxlen=1 << 16)
BETWEEN = "between steps"  # idle time the host spent under no span


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self._range = record_function(
            name, ", ".join(f"{k}={v}" for k, v in args.items()) if args else None)

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._range.__enter__()

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        SPAN_LOG.append((self.name, time.perf_counter() - self._t0))
        return False


def span(name: str, **args):
    """A span of the program (``name`` starts with ``ir.``; ``args``, such as
    ``step=``, go into the profiler's record): ``record_function`` while a
    profiler records, else ``NO_SPAN``."""
    if not torch._C._autograd._profiler_enabled():
        return NO_SPAN
    return _Span(name, args)


# the sparse-conv kernels' names as the profiler reports them, by wrapper:
# dx_list_tc_kernel is the down convs' dX (K1's counterpart over up8), the
# list pass (dw_list_count_kernel, dw_list_write_kernel) serves it and K3;
# the gather-GEMM templates end in MIRROR_T (true: K2's dX), the FMA dW one
# in GATHER_A (true: K3); dw_group_tc_kernel is K2's dW, dw_list_tc_kernel
# K3's at the downs; the stem kernels are K1's and K3's;
# sum_partials_kernel serves K2 and K3
KERNEL_FAMILIES = (
    ("K1 dX over up8", re.compile(r"dx_list_tc_kernel")),
    ("K1 forward", re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel")),
    ("K2", re.compile(r"gather_gemm(_tc)?_kernel<.*true>|dw_partial_kernel<.*false>"
                      r"|dw_group_tc_kernel")),
    ("down lists", re.compile(r"dw_list_(count|write)_kernel")),
    ("K3", re.compile(r"dw_partial_kernel<.*true>|dw_list_tc_kernel|stem_wide_dw_kernel")),
    ("K2/K3 sum of splits", re.compile(r"sum_partials_kernel")),
    ("inverse convs", re.compile(r"up_(fwd|dgrad|wgrad)_tc_kernel")),
)

# a wrapper's launch as the profiler names its kernels: the first kernel of
# each launch (K1, and the down convs' dX over the lists; K2's dX; K3; "L",
# the list pass a down's backward runs before both; "UP", each of the
# inverse convs' three kernels), then the kernels that finish it (K2's dW;
# the list pass's writes; the sum of the splits)
LAUNCH_FIRST = {
    "K1": re.compile(r"gather_gemm(_tc)?_kernel<.*false>|stem_wide_conv_kernel"
                     r"|dx_list_tc_kernel"),
    "K2": re.compile(r"gather_gemm(_tc)?_kernel<.*true>"),
    "K3": re.compile(r"dw_partial_kernel<.*true>|stem_wide_dw_kernel|dw_list_tc_kernel"),
    "L": re.compile(r"dw_list_count_kernel"),
    "UP": re.compile(r"up_(fwd|dgrad|wgrad)_tc_kernel"),
}
LAUNCH_REST = re.compile(r"dw_partial_kernel<.*false>|dw_group_tc_kernel|sum_partials_kernel"
                         r"|dw_list_write_kernel")
# profiles of one window, at most, before its disagreement with the launch
# counters is reported: the profiler can lose device records
PROFILE_TRIES = 3

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


def launches(names: Iterable[str]) -> Dict[str, int]:
    """Sparse-conv launches by wrapper: the kernels that open one."""
    seen = dict.fromkeys(LAUNCH_FIRST, 0)
    for name in names:
        fam = next((f for f, pat in LAUNCH_FIRST.items() if pat.search(name)), None)
        if fam is not None:
            seen[fam] += 1
    return seen


def counted(before: Sequence[int], after: Sequence[int]) -> Dict[str, int]:
    """What ``step_graph.launch_counts`` added between two readings, by the
    wrapper whose kernel opens the launch: (K1, K1 at the stems, K2, K3,
    K3 at the stems, the list pass, the downs' dX, the BN pair's two, the
    inverse convs) -> K1, K2, K3, L, UP (K1's and K3's counters count their
    stems and the dX too)."""
    d = [a - b for a, b in zip(after, before)]
    return {"K1": d[0], "K2": d[2], "K3": d[3], "L": d[5], "UP": d[9]}


def segments(spans: Iterable[Tuple[str, float, float]]) -> List[Tuple[float, float, tuple]]:
    """The host timeline cut where spans open and close: ``(start, end,
    chain)`` for each piece under at least one span, ``chain`` the names of
    the spans over it, outermost first."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    bounds = sorted({t for _, a, b in spans for t in (a, b)})
    out, active, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][1] <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[2] > a]
        if active:
            out.append((a, b, tuple(name for name, _, _ in active)))
    return out


def chain_at(segs: List[Tuple[float, float, tuple]], t: float) -> tuple:
    """The chain of spans over the host at time ``t`` (empty under none)."""
    i = bisect.bisect_right(segs, (t, float("inf"))) - 1
    return segs[i][2] if i >= 0 and segs[i][0] <= t < segs[i][1] else ()


def busy_and_gaps(device: Sequence[Tuple[str, float, float]],
                  window: Optional[Tuple[float, float]] = None):
    """(busy time, [(start, end, kernel before, kernel after)] of each idle
    gap) of device intervals ``(name, start, end)`` sorted by start: busy
    is their union (streams may overlap).  With ``window`` (start, end),
    the idle time before the first interval and after the last is a gap
    too (its kernel before or after None)."""
    busy, gaps, end, before = 0.0, [], None, None
    if window is not None and device and window[0] < device[0][1]:
        gaps.append((window[0], device[0][1], None, device[0][0]))
    for name, start, stop in device:
        if end is None or start > end:
            if end is not None:
                gaps.append((end, start, before, name))
            busy += stop - start
            end, before = stop, name
        elif stop > end:
            busy += stop - end
            end, before = stop, name
    if window is not None and end is not None and end < window[1]:
        gaps.append((end, window[1], before, None))
    return busy, gaps


def idle_by_span(gaps, segs) -> Dict[str, float]:
    """Each gap's time charged to the innermost span the host was in, a gap
    that crosses spans split between them; time under none is ``BETWEEN``."""
    out: Dict[str, float] = {}
    starts = [s[0] for s in segs]
    for a, b, _, _ in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                name = segs[i][2][-1]
                out[name] = out.get(name, 0.0) + hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            out[BETWEEN] = out.get(BETWEEN, 0.0) + (b - a - covered)
    return out


def _device_records(events) -> List[Tuple[str, float, float]]:
    """The device's kernel, copy and fill intervals (us), by start.
    Device-side spans of annotated ranges (an eager Adam step's, the spans')
    hold kernels counted on their own and are left out."""
    from torch.autograd import DeviceType

    return sorted(((ev.name, ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)), key=lambda r: r[1])


def _host_ranges(events, keep: Callable[[str], bool]) -> List[Tuple[str, float, float]]:
    """The host's ranges (us) whose name ``keep`` takes: the spans, say."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type == DeviceType.CPU and keep(ev.name)]


def profile_agreeing(run: Callable[[], None], tries: int = PROFILE_TRIES, log=None):
    """``run()`` under ``torch.profiler`` (CPU and CUDA activity), ended by
    a synchronize, until the window's sparse-conv launches by kernel name
    equal what the launch counters added over it, at most ``tries``
    windows.  Returns (the profile, wall seconds, a record: ``agrees``,
    ``why`` (None where it agrees), ``windows``, ``seen``, ``counted``) of
    the agreeing window, or of the last."""
    from torch.profiler import ProfilerActivity, profile

    from instancerefer_tpu_torch.train.step_graph import launch_counts

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        want = counted(before, launch_counts())
        device = _device_records(prof.events())
        seen = launches(name for name, _, _ in device)
        rec = {"agrees": seen == want, "why": None, "windows": attempt, "seen": seen,
               "counted": want}
        if rec["agrees"]:
            break
        rec["why"] = (f"window {attempt} of {tries}: the profiler's launches {seen} are not the "
                      f"counters' {want} ({len(device)} device records kept)")
        if log is not None:
            log(rec["why"])
    return prof, wall, rec


CALL = "device_profile.call"  # the profiler range around each call


def device_profile(fn: Callable[[], object], calls: int, top: int = 25,
                   gaps: int = 10) -> Dict[str, object]:
    """``calls`` calls of ``fn`` under ``torch.profiler`` after one call
    outside it, each ended by ``torch.cuda.synchronize()``, the window
    retaken until its launches agree with the counters
    (``profile_agreeing``: ``agrees``, ``why``, ``windows``); every time is
    a call's (the window's divided by ``calls``): ``wall_ms`` (host clock,
    the profiler's own cost included), ``device_busy_ms`` (the union of
    the device's kernel, memcpy and memset intervals), ``idle_share`` (1 -
    busy / wall), the device's idle ms inside the calls and between them
    (where the host waits, returns and starts the next call),
    ``idle_by_span`` (the idle ms by the innermost span the host was in),
    ``sparse_ms`` by ``KERNEL_FAMILIES``, ``dense_ms`` by
    ``KERNEL_CLASSES``, the ``top`` busiest kernels ``[name, launches a
    call, ms a call]`` and the ``gaps`` longest idle gaps of the device's
    timeline ``[ms, kernel before, kernel after, between calls, the
    innermost span at its middle]``.  The gaps cover the calls' window on
    the profiler's clock (``calls_ms``, its edges included), so
    ``idle_by_span`` sums to ``calls_ms`` less the busy time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            with record_function(CALL):
                fn()
                torch.cuda.synchronize()

    prof, wall, rec = profile_agreeing(run)
    wall *= 1e3
    events = prof.events()
    ranges = sorted(_host_ranges(events, CALL.__eq__), key=lambda r: r[1])
    starts = [start for _, start, _ in ranges]
    device = _device_records(events)
    segs = segments(_host_ranges(events, lambda name: name.startswith(SPAN_PREFIX)))
    sparse = {fam: 0.0 for fam, _ in KERNEL_FAMILIES}
    dense = {cls: 0.0 for cls, _ in KERNEL_CLASSES}
    by_name: Dict[str, List[float]] = {}
    for name, start, stop in device:
        ms = (stop - start) / 1e3
        fam = family_of(name)
        if fam is not None:
            sparse[fam] += ms
        else:
            dense[class_of(name)] += ms
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += ms
    # the calls' window on the profiler's clock, its edges' idle time too
    busy, raw = busy_and_gaps(device, (ranges[0][1], ranges[-1][2]))
    busy /= 1e3
    holes = sorted(((b - a) / 1e3, before or "", after or "", any(a < s <= b for s in starts),
                    (chain_at(segs, (a + b) / 2) or (BETWEEN,))[-1])
                   for a, b, before, after in raw)[::-1]
    names = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    per = 1.0 / calls
    return {
        **rec, "calls": calls, "wall_ms": wall * per, "device_busy_ms": busy * per,
        "idle_share": 1.0 - busy / wall if wall else None,
        "idle_within_calls_ms": sum(h[0] for h in holes if not h[3]) * per,
        "idle_between_calls_ms": sum(h[0] for h in holes if h[3]) * per,
        "calls_ms": (ranges[-1][2] - ranges[0][1]) / 1e3 * per,
        "idle_by_span": {k: v / 1e3 * per for k, v in sorted(
            idle_by_span(raw, segs).items(), key=lambda kv: -kv[1])},
        "sparse_ms": {k: v * per for k, v in sparse.items()},
        "dense_ms": {k: v * per for k, v in dense.items()},
        "top_kernels": [[name[:160], n * per, ms * per] for name, (n, ms) in names],
        "idle_gaps": [[ms, a[:100], b[:100], between, where]
                      for ms, a, b, between, where in holes[:gaps]],
    }


# ---------------------------------------------------------------- modules
BACKWARD_OP = "autograd::engine::evaluate_function"

# one host op as ``attribute`` reads it: ``id`` its place in the profile,
# ``corr`` the profiler's id (a runtime call's is that of the device records
# it made)
Op = collections.namedtuple("Op", "id corr name thread fwd_thread seq start end")
# the CUDA runtime's and driver's calls, which launch, copy and fill
RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


def host_ops(events) -> List[Op]:
    """The CPU ops of a profile, runtime calls among them."""
    from torch.autograd import DeviceType

    return [Op(i, ev.id, ev.name, ev.thread, ev.fwd_thread, ev.sequence_nr, ev.time_range.start,
               ev.time_range.end)
            for i, ev in enumerate(events) if ev.device_type == DeviceType.CPU and not ev.is_async]


def _parents(ops: List[Op]) -> Dict[int, Optional[Op]]:
    """Each op's innermost enclosing op on its own thread, by id."""
    parent: Dict[int, Optional[Op]] = {}
    by_thread: Dict[int, List[Op]] = {}
    for op in ops:
        by_thread.setdefault(op.thread, []).append(op)
    for thread_ops in by_thread.values():
        stack: List[Op] = []
        for op in sorted(thread_ops, key=lambda o: (o.start, -o.end)):
            while stack and stack[-1].end < op.end:
                stack.pop()
            parent[op.id] = stack[-1] if stack else None
            stack.append(op)
    return parent


def _ancestors(op: Op, parent: Dict[int, Optional[Op]]):
    p = parent.get(op.id)
    while p is not None:
        yield p
        p = parent.get(p.id)


def _spans_over(op: Op, parent: Dict[int, Optional[Op]]) -> tuple:
    """The spans over ``op`` on its own thread, outermost first (``op``
    itself last where it is one)."""
    return tuple(p.name for p in reversed([op] + list(_ancestors(op, parent)))
                 if p.name.startswith(SPAN_PREFIX))


def _node_of(op: Op, parent: Dict[int, Optional[Op]]) -> Optional[Op]:
    """The autograd node whose backward ``op`` runs in, or None."""
    return next((p for p in [op] + list(_ancestors(op, parent))
                 if p.name.startswith(BACKWARD_OP)), None)


def forward_spans(ops: List[Op], parent: Optional[Dict[int, Optional[Op]]] = None
                  ) -> Dict[Tuple[int, int], tuple]:
    """{(thread, sequence number): the spans over the op that made the
    autograd node of that number}: where a backward node of that number (on
    that forward thread) is charged.  An op records the number the next node
    will take, so every op since the last node carries it; the op that makes
    the node moves it on, so the last op to carry it is that op or one
    inside it."""
    parent = _parents(ops) if parent is None else parent
    out: Dict[Tuple[int, int], tuple] = {}
    for op in sorted(ops, key=lambda o: o.start):
        if op.seq >= 0 and _node_of(op, parent) is None:
            out[(op.thread, op.seq)] = _spans_over(op, parent)
    return out


def attribute(ops: List[Op]) -> List[Tuple[Op, tuple, str]]:
    """``(op, chain, side)`` for every op: ``chain`` the spans it is charged
    to (outermost first; empty: none) and ``side`` ``forward`` or
    ``backward``.  An op inside an autograd node's backward is charged to
    the spans of the forward op with the node's sequence number
    (``forward_spans``), else, as an op outside any backward, to the spans
    over it on its own thread; failing both, to the spans over the host at
    its start on any thread (the main thread's ``ir.backward`` around the
    autograd engine's thread on a card, say, for gradient accumulation,
    which has no forward op)."""
    parent = _parents(ops)
    forward = forward_spans(ops, parent)
    segs = segments((op.name, op.start, op.end) for op in ops
                    if op.name.startswith(SPAN_PREFIX))
    out = []
    for op in ops:
        node = _node_of(op, parent)
        chain = forward.get((node.fwd_thread, node.seq), ()) if node is not None else ()
        chain = chain or _spans_over(op, parent) or chain_at(segs, op.start)
        out.append((op, chain, "forward" if node is None else "backward"))
    return out


def charge_device(events) -> Dict[str, object]:
    """The device records of a profile (kernels, copies, fills) charged to
    spans: each through the runtime call that made it (the same profiler
    id), as ``attribute`` charges that call.  ``modules``: {chain: {side:
    us}}, busiest first; ``device_us`` and ``sparse_us``: all records' and
    the sparse-conv kernels'.  A record whose call the profiler did not keep
    is charged to none."""
    from torch.autograd import DeviceType

    ops = host_ops(events)
    charged = {op.id: (chain, side) for op, chain, side in attribute(ops)}
    launch = {op.corr: op for op in ops if RUNTIME.match(op.name)}
    modules: Dict[str, Dict[str, float]] = {}
    total = sparse = 0.0
    for ev in events:
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        us = ev.time_range.end - ev.time_range.start
        total += us
        sparse += us if family_of(ev.name) is not None else 0.0
        op = launch.get(ev.id)
        chain, side = charged[op.id] if op is not None else ((), None)
        if chain:
            row = modules.setdefault(" > ".join(chain), {"forward": 0.0, "backward": 0.0})
            row[side] += us
    return {"modules": dict(sorted(modules.items(), key=lambda kv: -sum(kv[1].values()))),
            "device_us": total, "sparse_us": sparse}


def module_split(fn: Callable[[], object], steps: int = 3, log=None) -> Dict[str, object]:
    """``steps`` calls of ``fn`` (eager steps: a replay keeps no spans)
    under ``torch.profiler`` after one outside it, retaken until the
    launches agree with the counters (``profile_agreeing``); device ms a
    call by the chain of spans each record is charged to (``attribute``),
    ``forward`` and ``backward``, ``unattributed`` (charged to none), the
    sparse-conv kernels' and the rest's ms, and ``masked_bn_ms`` (under
    ``ir.bn``, both sides)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(steps):
            fn()

    prof, _, rec = profile_agreeing(run, log=log)
    split = charge_device(prof.events())
    per = 1.0 / steps
    total, sparse = split["device_us"] / 1e3 * per, split["sparse_us"] / 1e3 * per
    modules = {k: {side: us / 1e3 * per for side, us in row.items()}
               for k, row in split["modules"].items()}
    unattributed = total - sum(sum(row.values()) for row in modules.values())
    return {**rec, "steps": steps, "device_ms": total, "sparse_ms": sparse,
            "dense_ms": total - sparse, "modules": modules, "unattributed_ms": unattributed,
            "unattributed_share": unattributed / total if total else None,
            "masked_bn_ms": sum(sum(row.values()) for k, row in modules.items()
                                if k.split(" > ")[-1] == "ir.bn")}
