"""Time the bf16 train and eval steps of several checkouts of the port,
alternated in one call on one GPU (eagerly, and as CUDA graphs where the
checkout has them), profile the host side of one step and the language
module of each, and time each checkout's sparse-conv wrappers at the stems'
and down convs' shapes and at every K1 tensor-core and K2 shape.

    python -m instancerefer_tpu_torch.scripts.step_ab ROOT [ROOT ...] \\
        [--rounds 2] [--steps 20] [--batch B] [--out FILE]

Each ROOT is a checkout holding ``chip_smoke.py`` and
``instancerefer_tpu_torch/``.  The step is the one that phase 7 of
``chip_smoke.py`` times (``train_step`` on a synthetic batch at
the fitted caps, random weights, Adam), run by ROOT's own package with
ROOT's own constants.  A round runs the roots in order and then in reverse
(A B B A), each in a fresh process, so a drift of the host over the call
falls on every root alike.  Each run prints one line ``STEP_AB {...}``:

- ``wall_ms``: each timed step, host clock around ``torch.cuda.synchronize()``;
- ``host_ms``: each step's time to return from ``train_step`` (its launches
  and the waits inside it); ``cpu_ms``: the process's CPU time over the step;
- ``gc_ms``: time in Python's garbage collector over all timed steps;
- ``probe_before`` / ``probe_after``: the host's speed: ``py_ms``, a fixed
  pure-Python loop, and ``op_us``, one small torch CPU op (the dispatch the
  step's launches go through); the best of 5 each;
- ``load1``: the host's 1-minute load average before the run;
- ``profile``: one step under ``torch.profiler``: device busy ms (the
  kernels, memcpys and memsets; not the device-side spans of annotated
  ranges such as Adam's step, ``annotated_ms``, which hold kernels counted
  on their own), the
  sparse-conv kernels' device ms by wrapper (ROOT's own
  ``chip_smoke.KERNEL_FAMILIES``), the busiest kernels (name, count,
  device ms), the host's self CPU ms over all ops, its busiest ops, and
  the CUDA runtime calls (count, self CPU ms);
- ``lang``: the language module's forward and backward alone (``ms``, a
  CUDA-event median; ``device_ms`` and ``gru_device_ms``, cuDNN's GRU ops,
  from one call under the profiler);
- ``eval_wall_ms``: each eager eval step (``chip_smoke.run_slice``: the
  eval forward, ``get_loss``, ``get_eval``), timed as ``wall_ms``;
- ``graph``: the same model's train and eval steps as CUDA graph replays
  (``train_wall_ms``, ``eval_wall_ms``), timed as ``wall_ms``;
- ``kernels_ms``: the device's ms a call of ROOT's wrappers on the same
  batch's maps, bf16 (``device_ms``: 20 calls captured into a CUDA graph,
  the median of 3 replays, so no host time between launches): K1 with its
  BN/ReLU epilogue at both stems, and K3 at both stems and every down conv
  of both encoders (``SHAPES``; K3 at a down runs its list pass and then
  the dW kernel); the stems at Cin 7, 10 and 135, each fed the rows its
  main path gives it (padded by ``gather_conv.pad_channels`` before the
  timing, as ``ops/sparse_conv.stem_input`` does); and K1 at every
  tensor-core shape of a train step (the downs and residuals with the
  epilogue; the downs' dX: ``conv_bwd.down_dx`` over the lists of the
  down map, built outside the timing as the down's backward shares them
  with K3) and K2 at every residual; beside each, ``kernels_bound`` (its
  valid map entries and the least ms an H100 could take, ``shape_bounds``)
  and ``kernels_plan`` (ROOT's ``tc_plan`` / ``dw_plan`` /
  ``dw_list_splits`` / ``dx_list_splits``).

``--batch B`` sets the scenes of the step's and the kernels' batch (default
ROOT's ``chip_smoke.BATCH``, 32; the bench runs 64).

Then a table of the runs, per root the median of its runs' medians, and
per shape the median of each root's kernel times.

    python -m instancerefer_tpu_torch.scripts.step_ab --plans B [B ...] [--out FILE]

times this checkout's K1, K2 and K3 instead (``plan_sweep``), at every K1
tensor-core and K2 shape of a train step of ``scripts/bench.py``'s batch of
B scenes, under every tile plan the kernels are built for and with K2's
dW at a half, 1, 2 and 3 times its splits, and K3 and the dX at every
down conv with their lists at a quarter, a half, 1, 2 and 4 times their
splits: how ``tc_plan``, ``dw_plan``, ``dw_list_splits`` and
``dx_list_splits`` were chosen.  The list lines also give the device ms a
call by kernel (K3: the list pass's two kernels, the dW kernel, the sum of
the splits) under the picked plan, from the profiler.

    python -m instancerefer_tpu_torch.scripts.step_ab --dw-groups [--out FILE]

times K2's dW alone at the pairs where its warps split a block's offsets
(``DW_GROUPS``: 16 -> 16, 32 -> 16, 32 -> 32, 48 -> 48) over their levels'
maps in PointGroup's cell, at several offsets a block each, from a library
the sweep builds for them (``dw_group_sweep``): how ``conv_bwd.
dw_group_split``'s G was chosen.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

PREFIX = "STEP_AB "
WIDTHS = (32, 64, 128, 128, 128)  # the encoders' channels by stage
STEM_CINS = (7, 10, 135)  # the stems' Cin: the default config, use_normal, use_multiview
TC_WRAPPERS = ("gather_conv", "subm_conv_bwd")  # the labels of K1's tile route and K2


def _shapes():
    """(label, wrapper, map key, key of the map whose rows are the input,
    Cin, Cout) of the K1 stems and of every K3 launch of a train step, and
    of the stems at the other input widths; then every K1 tensor-core shape
    of a train step (the downs and residuals of both encoders, the downs'
    dX over ``up8``: wrapper ``gather_conv_dx``, Cin the down's Cout) and
    every K2 shape (the residuals).  A map key ``<p>_up8_<s>`` names the
    inverse of ``<p>_down_<s>`` (``shape_map``)."""
    shapes = []
    for enc, p in (("scene", "scene"), ("instance", "inst")):
        for cin in STEM_CINS:
            stem = (f"{p}_nbr3_0", f"{p}_nbr3_0", cin, WIDTHS[0])
            tag = "" if cin == 7 else f" Cin {cin}"
            shapes += [(f"K1 {enc} stem{tag}", "gather_conv", *stem),
                       (f"K3 {enc} stem{tag}", "conv_dw", *stem)]
        shapes += [(f"K3 {enc} stage{s} down", "conv_dw", f"{p}_down_{s}", f"{p}_nbr3_{s - 1}",
                    WIDTHS[s - 1], WIDTHS[s]) for s in range(1, 5)]
    for enc, p in (("scene", "scene"), ("instance", "inst")):
        for s in range(1, 5):
            shapes += [
                (f"K1 {enc} stage{s} down", "gather_conv", f"{p}_down_{s}", f"{p}_nbr3_{s - 1}",
                 WIDTHS[s - 1], WIDTHS[s]),
                (f"K1 {enc} stage{s} residual", "gather_conv", f"{p}_nbr3_{s}", f"{p}_nbr3_{s}",
                 WIDTHS[s], WIDTHS[s]),
                (f"K1 {enc} stage{s} down dX over up8", "gather_conv_dx", f"{p}_up8_{s}",
                 f"{p}_nbr3_{s}", WIDTHS[s], WIDTHS[s - 1]),
                (f"K2 {enc} stage{s} residual", "subm_conv_bwd", f"{p}_nbr3_{s}",
                 f"{p}_nbr3_{s}", WIDTHS[s], WIDTHS[s]),
            ]
    return shapes


def shape_map(batch, key: str):
    """The int32 map ``key`` of a host batch; ``<p>_up8_<s>`` is built from
    the batch's ``uprow``/``upk`` as ``data/host.batch_to_torch`` builds it."""
    import numpy as np

    if "_up8_" in key:
        from instancerefer_tpu_torch.ops import voxelize

        p, s = key.split("_up8_")
        return voxelize.build_up8(batch[f"{p}_uprow_{s}"], batch[f"{p}_upk_{s}"])
    return np.ascontiguousarray(batch[key], np.int32)


SHAPES = _shapes()


def host_probe() -> dict:
    """The host's speed: ``py_ms``, a fixed pure-Python loop, and ``op_us``, one
    small torch CPU op (the dispatch a step's launches go through); the best
    of 5 each."""
    import torch

    def py_loop() -> float:
        t0, s = time.perf_counter(), 0
        for i in range(200_000):
            s += i * i
        return (time.perf_counter() - t0) * 1e3

    a, b = torch.ones(1), torch.ones(1)

    def op() -> float:
        t0 = time.perf_counter()
        for _ in range(2000):
            torch.add(a, b)
        return (time.perf_counter() - t0) / 2000 * 1e6

    return {"py_ms": min(py_loop() for _ in range(5)), "op_us": min(op() for _ in range(5))}


def _profile(fn, families=()) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = host = annotated = 0.0
    ops, kernels, runtime = [], [], {}
    by_family = {name: 0.0 for name, _ in families}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and getattr(ev, "is_user_annotation", False):
            # a range (Adam's step) that spans kernels counted on their own
            annotated += ev.self_device_time_total / 1e3
            continue
        if ev.device_type == DeviceType.CUDA:
            device += ev.self_device_time_total / 1e3
            kernels.append([ev.key[:120], ev.count, round(ev.self_device_time_total / 1e3, 3)])
            family = next((name for name, pat in families if pat.search(ev.key)), None)
            if family is not None:
                by_family[family] += ev.self_device_time_total / 1e3
            continue
        ms = ev.self_cpu_time_total / 1e3
        host += ms
        if ev.key.startswith("cu"):
            runtime[ev.key] = [ev.count, round(ms, 3)]
        else:
            ops.append([ev.key, ev.count, round(ms, 3)])
    ops.sort(key=lambda r: -r[2])
    kernels.sort(key=lambda r: -r[2])
    return {"wall_ms": wall, "device_busy_ms": device, "annotated_ms": annotated,
            "kernels_by_wrapper_ms": by_family,
            "host_self_cpu_ms": host, "top_ops": ops[:12], "top_kernels": kernels[:25],
            "runtime": runtime}


def device_ms(fn, launches: int = 20) -> float:
    """ms a call of ``fn`` on the device: ``launches`` calls captured into
    one CUDA graph, the median of 3 timed replays (no host time between
    launches)."""
    import torch

    fn()  # warm (and build)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def kernel_split(fn, calls: int = 20) -> dict:
    """Device ms a call of ``fn`` by kernel (its short name), from
    ``torch.profiler`` over ``calls`` calls after a warm one."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            name = re.sub(r"\(.*", "", ev.key).split("::")[-1]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / calls
    return out


def _time_kernels(batch, dev, timer, labels=None) -> dict:
    """ROOT's K1, K2 and K3 wrappers at ``SHAPES`` (those of ``labels`` where
    given), bf16, random inputs, each timed by ``timer`` (a call -> ms)."""
    import torch

    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    out = {}
    for label, wrapper, key, in_key, cin, cout in SHAPES:
        if labels is not None and label not in labels:
            continue
        nbr = torch.from_numpy(shape_map(batch, key)).to(dev)
        k = nbr.shape[1]
        x = rnd(batch[in_key].shape[0], cin).bfloat16()
        if "stem" in label:
            x = G.pad_channels(x)  # the rows the stem's main path gives it
        w = (rnd(k, cin, cout) / (k * cin) ** 0.5).bfloat16()
        if wrapper == "gather_conv":
            sc, bi = 0.5 + torch.rand(cout, device=dev, generator=gen), 0.1 * rnd(cout)
            out[label] = timer(lambda: G.gather_conv(x, nbr, w, sc, bi, relu=True))
        elif wrapper == "gather_conv_dx":
            # over the lists of the down map (built outside the timing: the
            # down's backward shares them with K3), W as stored
            down = torch.from_numpy(shape_map(batch, key.replace("_up8_", "_down_"))).to(dev)
            ws, work = w.transpose(1, 2).contiguous(), conv_bwd.down_lists(down)
            out[label] = timer(lambda: conv_bwd.down_dx(x, down, nbr, ws, work))
        elif wrapper == "subm_conv_bwd":
            g = rnd(nbr.shape[0], cout).bfloat16()
            out[label] = timer(lambda: conv_bwd.subm_conv_bwd(x, nbr, g, w))
        else:
            g = rnd(nbr.shape[0], cout).bfloat16()
            out[label] = timer(lambda: conv_bwd.conv_dw(x, nbr, g, cin=cin))
    return out


def shape_bounds(batch, peak_flops: float = 989e12, peak_bytes_s: float = 3.35e12) -> dict:
    """Per label of ``SHAPES``, bf16: (valid map entries, the least ms an
    H100 could take: the larger of the valid entries' flops (x2 for K2's
    two products) over ``peak_flops`` and the bytes the function must move
    (inputs read once, outputs written once: bf16 rows, weights and dX,
    int32 map, f32 dW) over ``peak_bytes_s``)."""
    out = {}
    for label, wrapper, key, in_key, cin, cout in SHAPES:
        nbr = shape_map(batch, key)
        (v_out, k), v_in = nbr.shape, batch[in_key].shape[0]
        nnz = int((nbr >= 0).sum())
        flops = 2 * nnz * cin * cout * (2 if wrapper == "subm_conv_bwd" else 1)
        nb = nbr.nbytes
        if wrapper == "gather_conv":  # x, W, scale/bias in; bf16 out
            nb += 2 * (v_in * cin + k * cin * cout + v_out * cout) + 8 * cout
        elif wrapper == "gather_conv_dx":  # g, W^T in; bf16 dX out
            nb += 2 * (v_in * cin + k * cin * cout + v_out * cout)
        elif wrapper == "subm_conv_bwd":  # x, g, W in; bf16 dX and f32 dW out
            nb += 2 * (v_out * (cin + cout) + k * cin * cout + v_out * cin) + 4 * k * cin * cout
        else:  # x, g in; f32 dW out
            nb += 2 * (v_in * cin + v_out * cout) + 4 * k * cin * cout
        out[label] = (nnz, max(flops / peak_flops, nb / peak_bytes_s) * 1e3)
    return out


def shape_plans(batch, sms: int) -> dict:
    """Per K1 tensor-core, K2 and K3-down label of ``SHAPES``: the plans
    ROOT's package picks for it (``tc_plan``; for K2 also ``dw_plan``; for
    K3 ``dw_list_splits``; for the downs' dX ``dx_list_splits``)."""
    import torch

    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    out = {}
    for label, wrapper, key, in_key, cin, cout in SHAPES:
        v, k = shape_map(batch, key).shape
        if wrapper == "conv_dw" and cin in G.TC_WIDTHS:
            out[label] = [conv_bwd.dw_list_splits(v, k, cin, cout, sms)]
        elif wrapper == "gather_conv_dx":
            v_down = batch[in_key].shape[0]  # the down map's rows
            out[label] = ["lists", conv_bwd.dx_list_splits(v_down, k, cout, cin, sms)]
        elif wrapper == "gather_conv" and cin in G.TC_WIDTHS:
            out[label] = list(G.tc_plan(v, k, cin, cout, torch.bfloat16, sms))
        elif wrapper == "subm_conv_bwd":
            out[label] = list(G.tc_plan(v, k, cout, cin, torch.bfloat16, sms)) + \
                list(conv_bwd.dw_plan(v, k, cin, cout, sms))
    return out


def _walls(fn, steps: int):
    """Each of ``steps`` calls of ``fn`` in ms, host clock around
    ``torch.cuda.synchronize()``, after 2 warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _lang_profile(model, dd, median_ms) -> dict:
    """The language module's forward and backward alone (train mode, the
    sum of its outputs as the loss): its CUDA-event median, and one call
    under ``torch.profiler``: all its device ms, and those of cuDNN's GRU
    ops (``_cudnn_rnn`` and its backward, the kernels they launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def lang_step():
        out = model.lang(dd)
        sum(v.float().sum() for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.requires_grad).backward()

    ms = median_ms(lang_step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lang_step()
        torch.cuda.synchronize()
    device = gru = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device += ev.self_device_time_total / 1e3
        elif "_cudnn_rnn" in ev.key:
            gru += ev.device_time_total / 1e3
    model.zero_grad(set_to_none=True)
    return {"ms": ms, "device_ms": device, "gru_device_ms": gru}


def child(steps: int, batch_size: int = 0) -> dict:
    sys.path.insert(0, os.getcwd())  # ROOT's package and chip_smoke.py
    import gc

    import torch

    import chip_smoke as cs
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    if not torch.cuda.is_available():
        raise SystemExit("step_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gather_conv.build()
    spec = BatchSpec(**cs.SPEC_KW)
    batch = make_batch(batch_size or cs.BATCH, spec, seed=0, mean_size_arr=cs.MEAN_SIZE,
                       **cs.SCENE_KW)
    dd = batch_to_torch(batch, spec, dev)
    set_compute_dtype("bfloat16")
    model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                          generator=torch.Generator().manual_seed(5)).to(dev)
    opt = make_optimizer(model.parameters(), cs.LR, cs.WD)
    mean_size = torch.tensor(cs.MEAN_SIZE, dtype=torch.float32, device=dev)

    def step():
        return train_step(model, opt, dd, mean_size)

    load1 = os.getloadavg()[0]
    probe_before = host_probe()
    for _ in range(2):  # warm-up
        step()
    torch.cuda.synchronize()
    in_gc, gc_start = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - gc_start[0]

    wall, host, cpu, losses = [], [], [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            # only the metrics (detached) are kept: outputs held past the
            # step keep its autograd graph, whose gradient accumulators
            # would run on this stream inside the graph capture below
            metrics = step()[0]
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2, c1 = time.perf_counter(), time.process_time()
            wall.append((t2 - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
            cpu.append((c1 - c0) * 1e3)
            losses.append(metrics["loss"])
    finally:
        gc.callbacks.remove(on_gc)
    if not all(bool(torch.isfinite(x)) for x in losses):
        raise AssertionError("non-finite loss")
    probe_after = host_probe()
    prof = _profile(step, cs.KERNEL_FAMILIES)
    lang = _lang_profile(model.train(), dd, cs.median_ms)
    eval_wall = _walls(lambda: cs.run_slice(model.eval(), dd, mean_size), steps)
    graphs = StepGraphs(model, opt, mean_size)  # the same model and batch, replayed
    graphs.train_step(dd)
    graphs.eval_step(dd)
    key = dd["lang_feat"].shape[1]
    t_in = graphs.graphs[graphs.key("train", key)].inputs
    e_in = graphs.graphs[graphs.key("eval", key)].inputs
    graph = {"train_wall_ms": _walls(lambda: graphs.train_step(t_in), steps),
             "eval_wall_ms": _walls(lambda: graphs.eval_step(e_in), steps)}
    set_compute_dtype(None)
    kernels = _time_kernels(batch, dev, device_ms)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"wall_ms": wall, "host_ms": host, "cpu_ms": cpu, "gc_ms": in_gc[0] * 1e3,
            "probe_before": probe_before, "probe_after": probe_after, "load1": load1,
            "profile": prof, "lang": lang, "eval_wall_ms": eval_wall, "graph": graph,
            "kernels_ms": kernels, "kernels_bound": shape_bounds(batch),
            "kernels_plan": shape_plans(batch, sms)}


def tc_labels(widths) -> list:
    """The labels of ``SHAPES`` that K1's tensor-core route and K2 serve
    (``widths``: the Cin the tensor-core kernels are built for)."""
    return [label for label, wrapper, _, _, cin, _ in SHAPES
            if wrapper in TC_WRAPPERS and cin in widths]


def list_labels(widths) -> list:
    """The labels of ``SHAPES`` that the routes over the per-offset lists of
    the down maps serve: K3 at the downs and the downs' dX."""
    return [label for label, wrapper, _, _, cin, _ in SHAPES
            if wrapper in ("conv_dw", "gather_conv_dx") and cin in widths]


@contextlib.contextmanager
def forced_plans(tile=None, dw_scale=None, list_scale=None):
    """Inside, every tensor-core gather-GEMM launch (K1, K2's dX) takes the
    tile plan ``tile`` ((rows, cluster)), K2's dW ``dw_scale`` times the
    splits ``dw_plan`` picks and K3's lists ``list_scale`` times those of
    ``dw_list_splits`` (both within ``DW_PARTIAL_BYTES``), and the downs' dX
    ``list_scale`` times the blocks a list of ``dx_list_splits``, where
    given; the plan functions are restored after."""
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    saved = (G.tc_plan, conv_bwd.tc_plan, conv_bwd.dw_plan, conv_bwd.dw_list_splits,
             conv_bwd.dx_list_splits)
    if tile is not None:
        G.tc_plan = conv_bwd.tc_plan = lambda rows, k, *_: G.TcPlan(*tile, -(-k // tile[1]))

    def scaled(splits, scale, k, cin, cout):
        cap = conv_bwd.DW_PARTIAL_BYTES // (4 * k * cin * cout)
        return max(1, min(int(scale * splits), cap))

    if dw_scale is not None:
        def dw_plan(rows, k, cin, cout, sms):
            plan = saved[2](rows, k, cin, cout, sms)
            return plan._replace(splits=scaled(plan.splits, dw_scale, k, cin, cout))

        conv_bwd.dw_plan = dw_plan
    if list_scale is not None:
        conv_bwd.dw_list_splits = lambda rows, k, cin, cout, sms: scaled(
            saved[3](rows, k, cin, cout, sms), list_scale, k, cin, cout)
        conv_bwd.dx_list_splits = lambda rows, k, cin, cout, sms: max(
            1, int(list_scale * saved[4](rows, k, cin, cout, sms)))
    try:
        yield
    finally:
        (G.tc_plan, conv_bwd.tc_plan, conv_bwd.dw_plan, conv_bwd.dw_list_splits,
         conv_bwd.dx_list_splits) = saved


def plan_sweep(batch_sizes, out_path=None, dw_scales=(0.5, 1, 2, 3),
               list_scales=(0.25, 0.5, 1, 2, 4)) -> None:
    """At each of ``batch_sizes`` (``scripts/bench.py``'s batch), every label
    of ``tc_labels`` timed by ``device_ms`` under each plan of
    ``gather_conv.TC_PLANS``, and K2 also with its dW at ``dw_scales`` times
    its splits; every label of ``list_labels`` (K3 at the downs, the downs'
    dX) with its lists at ``list_scales`` times their splits: one line a
    shape (valid
    entries, bound, the plans the plan functions pick, the ms of each
    variant); with ``out_path``, one JSON record a shape appended there
    too."""
    import torch

    from instancerefer_tpu_torch.config import band_profile_kwargs
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.ops import gather_conv as G
    from instancerefer_tpu_torch.scripts import bench

    if not torch.cuda.is_available():
        raise SystemExit("step_ab --plans: no CUDA device")
    dev = torch.device("cuda", 0)
    G.build()
    sms = G.sm_count(dev)
    caps = band_profile_kwargs(bench.PROFILE)
    spec = BatchSpec(**{k: caps[k] for k in ("scene_caps", "inst_caps", "max_candidates",
                                            "max_instances")})
    labels = tc_labels(G.TC_WIDTHS) + list_labels(G.TC_WIDTHS)
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; device ms a call by tile plan (rows x "
          f"cluster), by K2's dW splits and by K3's list splits (x the picked); the picked "
          f"plans beside", flush=True)
    for b in batch_sizes:
        batch = make_batch(b, spec, seed=0, mean_size_arr=bench.MEAN_SIZE, **bench.SCENE_KW)
        bounds, plans = shape_bounds(batch), shape_plans(batch, sms)
        ms = {label: {} for label in labels}
        for tile in G.TC_PLANS:
            with forced_plans(tile=tile):
                for label, t in _time_kernels(batch, dev, device_ms,
                                              tc_labels(G.TC_WIDTHS)).items():
                    ms[label][f"{tile[0]}x{tile[1]}"] = t
        for m in list_scales:
            with forced_plans(list_scale=m):
                for label, t in _time_kernels(batch, dev, device_ms,
                                              list_labels(G.TC_WIDTHS)).items():
                    ms[label][f"lists x{m:g}"] = t
        k2 = [label for label in labels if label.startswith("K2")]
        for m in dw_scales:
            with forced_plans(dw_scale=m):
                for label, t in _time_kernels(batch, dev, device_ms, k2).items():
                    ms[label][f"dW x{m:g}"] = t
        split = _time_kernels(batch, dev, kernel_split, list_labels(G.TC_WIDTHS))
        for label in labels:
            nnz, bound_ms = bounds[label]
            print(f"B={b} {label}: valid={nnz} bound {bound_ms:.4f} plan {plans[label]}: "
                  + ", ".join(f"{p} {t:.4f}" for p, t in ms[label].items())
                  + ("; by kernel " + ", ".join(f"{k} {t:.4f}" for k, t in split[label].items())
                     if label in split else ""), flush=True)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps({"batch": b, "label": label, "valid": nnz,
                                        "bound_ms": bound_ms, "plan": plans[label],
                                        "ms": ms[label], "by_kernel": split.get(label)}) + "\n")


# K2's dW where the warps of a block split its offsets (WG > 1 in
# ops/conv_bwd.dw_group_split): (Cin, Cout) -> the level of PointGroup's
# U-Net whose map it runs over in the cell, and the offsets a block that
# ``dw_group_sweep`` times there
DW_GROUPS = {(16, 16): (0, (2, 4, 5, 6, 7, 8, 14)),
             (32, 16): (0, (2, 3, 4, 6, 8)),
             (32, 32): (1, (2, 3, 4)),
             (48, 48): (2, (1, 2, 3, 4))}
PG_WORKLOAD, PG_SEED = "pointgroup-train-resident", 15  # chip_smoke.py phase 15's batch


def dw_bound_ms(nnz: int, rows: int, k: int, cin: int, cout: int, peak_flops: float = 989e12,
                peak_bytes_s: float = 3.35e12) -> float:
    """The least ms an H100 could take for K2's dW alone over a ``rows`` x
    ``k`` map of ``nnz`` valid entries: the larger of 2 nnz cin cout flops
    over ``peak_flops`` and the bytes it must move (the map, x and g read
    once, the f32 dW written) over ``peak_bytes_s``."""
    nb = 4 * rows * k + 2 * rows * (cin + cout) + 4 * k * cin * cout
    return max(2 * nnz * cin * cout / peak_flops, nb / peak_bytes_s) * 1e3


def _sweep_library(groups):
    """A library of its own for the sweep: ``dw_group_tc_kernel`` at every
    (Cin, Cout, G) of ``groups``, built with the package's flags from a
    source written into its build directory.  ``ir_dw_group_sweep`` launches
    one (its kernel and the sum of the splits) and
    ``ir_dw_group_sweep_occupancy`` reads what the card holds of it and
    raises its shared-memory limit, which the first must follow."""
    import ctypes
    import hashlib
    import subprocess

    from instancerefer_tpu_torch.ops import gather_conv as G

    cases = "".join(f"  X({ci}, {co}, {g})\n" for ci, co, g in groups)
    src = ("#include \"sparse_conv_tc.cuh\"\n"
           "using namespace irsc::tc;\n"
           "extern \"C\" int ir_dw_group_sweep(const void* x, const void* g, const void* nbr,"
           " void* partial, void* dw, long long rows, int k, int cin, int cout, int group,"
           " int splits, void* stream) {\n"
           "#define X(CI, CO, GR) if (cin == CI && cout == CO && group == GR) return "
           "launch_dw_group_grid<CI, CO, GR>(x, g, nbr, partial, dw, rows, k, splits, "
           "static_cast<cudaStream_t>(stream));\n" + cases + "#undef X\n"
           "  return cudaErrorInvalidValue;\n}\n"
           "extern \"C\" int ir_dw_group_sweep_occupancy(int cin, int cout, int group, int* regs,"
           " int* bound) {\n"
           "#define X(CI, CO, GR) if (cin == CI && cout == CO && group == GR) return "
           "dw_group_occupancy<CI, CO, GR>(regs, bound);\n" + cases + "#undef X\n"
           "  return -1;\n}\n")
    h = hashlib.sha256(src.encode() + " ".join(G.NVCC_FLAGS).encode())
    for name in sorted(os.listdir(G.CSRC)):
        with open(os.path.join(G.CSRC, name), "rb") as f:
            h.update(f.read())
    lib = os.path.join(G.BUILD_DIR, f"dw_group_sweep_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(G.BUILD_DIR, exist_ok=True)
        with open(lib[:-3] + ".cu", "w") as f:
            f.write(src)
        proc = subprocess.run([G._nvcc(), *G.NVCC_FLAGS, "-I", G.CSRC, "-o", lib, lib[:-3] + ".cu"],
                              capture_output=True, text=True)
        with open(lib[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode:
            raise RuntimeError("the sweep's library did not build\n" + proc.stdout + proc.stderr)
    out = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    out.ir_dw_group_sweep.restype = i
    out.ir_dw_group_sweep.argtypes = [p] * 5 + [ctypes.c_longlong] + [i] * 5 + [p]
    out.ir_dw_group_sweep_occupancy.restype = i
    out.ir_dw_group_sweep_occupancy.argtypes = [i] * 3 + [ctypes.POINTER(i)] * 2
    return out


def pointgroup_levels(dev, seed: int = PG_SEED):
    """[(rows, nbr3)] by level of the first pool batch of PointGroup's cell
    (its traffic at the configuration's capacities, as ``chip_smoke.py``
    phase 15 builds it), on ``dev``."""
    sys.path.insert(0, os.getcwd())  # the checkout's benchmark/
    from benchmark import run as bench_run
    from benchmark.drivers import pointgroup as drv

    _, values, traffic, _, _, _ = bench_run.cell_data(os.getcwd(), PG_WORKLOAD)
    traffic = {**traffic, "pool_batches": 1}
    spec = drv.level_spec(values, traffic)
    host = drv.host_batches(drv.make_pool(seed, traffic), spec)[0]
    staged = {k: v.to(dev) for k, v in spec.stage(host).items()}
    return [(sv.mask.numel(), sv.nbr3) for sv in spec.finish(staged)["pyramid"]]


def dw_group_sweep(out_path=None, groups=None) -> None:
    """K2's dW alone at each pair of ``groups`` (default ``DW_GROUPS``) over
    its level's map in PointGroup's cell, at each of its offsets a block G:
    the splits ``conv_bwd.dw_group_splits`` gives that G, the card's
    registers and blocks an SM, and the device ms a call (``device_ms``)
    beside the bound (``dw_bound_ms``); each G's dW held against the plain
    twin first.  One line a pair; with ``out_path``, one JSON record a pair
    appended there too.  The rule's G (``conv_bwd.dw_group``) is marked."""
    import ctypes

    import torch

    from instancerefer_tpu_torch.ops import conv_bwd, sparse
    from instancerefer_tpu_torch.ops import gather_conv as G

    if not torch.cuda.is_available():
        raise SystemExit("step_ab --dw-groups: no CUDA device")
    groups = DW_GROUPS if groups is None else groups
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's products in f32
    sms = G.sm_count(dev)
    lib = _sweep_library([(ci, co, g) for (ci, co), (_, gs) in groups.items() for g in gs])
    levels = pointgroup_levels(dev)
    gen = torch.Generator(device=dev).manual_seed(PG_SEED)
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; K2's dW alone in {PG_WORKLOAD} (seed "
          f"{PG_SEED}'s first batch), device ms a call by offsets a block G [splits, blocks an "
          f"SM, registers]; * the rule's G", flush=True)
    for (cin, cout), (level, gs) in groups.items():
        rows, nbr = levels[level]
        k = nbr.shape[1]
        nnz = int((nbr >= 0).sum())
        x = torch.randn(rows, cin, device=dev, generator=gen).bfloat16()
        g = torch.randn(rows, cout, device=dev, generator=gen).bfloat16()
        want = sparse.subm_conv_bwd(x.float(), nbr, g.float(),
                                    torch.zeros(k, cin, cout, device=dev))[1]
        dw = torch.empty(k, cin, cout, device=dev)
        ms = {}
        for grp in gs:
            regs, bound = ctypes.c_int(), ctypes.c_int()
            blocks = lib.ir_dw_group_sweep_occupancy(cin, cout, grp, regs, bound)
            splits = conv_bwd.dw_group_splits(rows, k, cin, cout, sms, grp)
            partial = torch.empty(splits, k, cin, cout, device=dev)

            def call():  # on the current stream: a capture's, inside device_ms
                G.check_launch("dw_group_sweep", lib.ir_dw_group_sweep(
                    x.data_ptr(), g.data_ptr(), nbr.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), rows, k, cin, cout, grp, splits, G.cuda_stream(x)))

            call()
            err = (dw - want).abs().max().item() / want.abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"K2 dW {cin}->{cout} G={grp}: max rel err {err:.3e}")
            ms[grp] = {"ms": device_ms(call), "splits": splits, "blocks": blocks,
                       "bound_blocks": bound.value, "regs": regs.value}
        bound_ms = dw_bound_ms(nnz, rows, k, cin, cout)
        rule = conv_bwd.dw_group(cin, cout)
        print(f"{cin}->{cout} level {level}: rows={rows} valid={nnz} bound {bound_ms:.4f}: "
              + ", ".join(f"G={grp}{'*' if grp == rule else ''} {r['ms']:.4f} [{r['splits']}, "
                          f"{r['blocks']}, {r['regs']}]" for grp, r in ms.items()), flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps({"pair": [cin, cout], "level": level, "rows": rows,
                                    "valid": nnz, "bound_ms": bound_ms, "rule_g": rule,
                                    "by_group": ms}) + "\n")


def _order(roots, rounds: int):
    return [r for _ in range(rounds) for r in list(roots) + list(roots)[::-1]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkouts holding chip_smoke.py")
    ap.add_argument("--rounds", type=int, default=2, help="A B B A rounds")
    ap.add_argument("--steps", type=int, default=20, help="timed steps a run")
    ap.add_argument("--out", help="also append each run's record to this file")
    ap.add_argument("--batch", type=int, default=0,
                    help="scenes a batch (default: ROOT's chip_smoke.BATCH)")
    ap.add_argument("--plans", type=int, nargs="+", metavar="B",
                    help="instead of an A/B, sweep this checkout's tile plans at batches B")
    ap.add_argument("--dw-groups", action="store_true",
                    help="instead of an A/B, sweep K2's dW offsets a block at PointGroup's "
                         "narrow pairs")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(PREFIX + json.dumps(child(args.steps, args.batch)), flush=True)
        return
    if args.plans:
        plan_sweep(args.plans, args.out)
        return
    if args.dw_groups:
        dw_group_sweep(args.out)
        return
    if not args.roots:
        ap.error("give at least one ROOT")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for i, root in enumerate(_order([os.path.abspath(r) for r in args.roots], args.rounds)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--steps", str(args.steps),
             "--batch", str(args.batch)],
            cwd=root, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(PREFIX)]
        if proc.returncode or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"step_ab: run {i} of {root} failed (rc {proc.returncode})")
        rec = dict(json.loads(lines[-1][len(PREFIX):]), run=i, root=root)
        runs.append(rec)
        print(PREFIX + json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    med = statistics.median
    print("run  root                  wall ms med [min, max]     host ms  cpu ms  gc ms  "
          "busy ms  K3 ms  py ms before/after  op us before/after  load1")
    for r in runs:
        p = r["probe_before"], r["probe_after"]
        k3 = r["profile"]["kernels_by_wrapper_ms"].get("K3", float("nan"))
        print(f"{r['run']:>3}  {os.path.basename(r['root']):<20}  {med(r['wall_ms']):8.2f} "
              f"[{min(r['wall_ms']):.2f}, {max(r['wall_ms']):.2f}]  {med(r['host_ms']):7.2f}  "
              f"{med(r['cpu_ms']):6.2f}  {r['gc_ms']:5.2f}  {r['profile']['device_busy_ms']:7.2f}  "
              f"{k3:5.2f}  {p[0]['py_ms']:.2f} / {p[1]['py_ms']:.2f}  "
              f"{p[0]['op_us']:.3f} / {p[1]['op_us']:.3f}  {r['load1']:.2f}")
    for root in dict.fromkeys(r["root"] for r in runs):
        mine = [r for r in runs if r["root"] == root]
        walls = [med(r["wall_ms"]) for r in mine]
        line = (f"{os.path.basename(root)}: median step {med(walls):.2f} ms over {len(mine)} "
                f"runs ({', '.join(f'{w:.2f}' for w in walls)})")
        if len(mine) > 2:  # does the step follow the host's speed across runs?
            line += "; correlation with the probes " + ", ".join(
                f"{key} {statistics.correlation(walls, [r['probe_before'][key] for r in mine]):.3f}"
                for key in ("py_ms", "op_us"))
        print(line)
    roots = list(dict.fromkeys(r["root"] for r in runs))
    print("root: median over its runs of each run's median ms: eager train, eager eval, graph "
          "train, graph eval; the language module's forward+backward (CUDA events), its device "
          "ms and cuDNN's GRU ops' device ms (profiler)")
    for root in roots:
        mine = [r for r in runs if r["root"] == root]

        def mm(get, mine=mine):
            vals = [get(r) for r in mine]
            return "-" if None in vals else f"{med(vals):.2f}"

        print(f"  {os.path.basename(root)}: " + ", ".join((
            mm(lambda r: med(r["wall_ms"])), mm(lambda r: med(r["eval_wall_ms"])),
            mm(lambda r: med(r["graph"]["train_wall_ms"]) if r["graph"] else None),
            mm(lambda r: med(r["graph"]["eval_wall_ms"]) if r["graph"] else None),
            mm(lambda r: r["lang"]["ms"]), mm(lambda r: r["lang"]["device_ms"]),
            mm(lambda r: r["lang"]["gru_device_ms"]))))
    print("kernel ms a launch, bf16, median of each root's runs: " + ", ".join(
        os.path.basename(root) for root in roots) + "; valid map entries; bound ms (H100 "
        "peaks); each root's plan where it has one")
    for label, *_ in SHAPES:
        nnz, bound_ms = runs[0]["kernels_bound"][label]
        plans = [next((r["kernels_plan"].get(label) for r in runs if r["root"] == root), None)
                 for root in roots]
        print(f"  {label}: " + ", ".join(
            f"{med(r['kernels_ms'][label] for r in runs if r['root'] == root):.4f}"
            for root in roots) + f"; valid {nnz}; bound {bound_ms:.4f}"
            + "".join(f"; plan {p}" for p in plans if p))


if __name__ == "__main__":
    main()
