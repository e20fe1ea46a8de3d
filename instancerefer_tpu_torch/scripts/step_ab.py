"""Time the bf16 train and eval steps of several checkouts of the port,
alternated in one call on one GPU (eagerly, and as CUDA graphs where the
checkout has them), profile the host side of one step and the language
module of each, and time each checkout's sparse-conv wrappers at the stems'
and down convs' shapes.

    python -m instancerefer_tpu_torch.scripts.step_ab ROOT [ROOT ...] \\
        [--rounds 2] [--steps 20] [--out FILE]

Each ROOT is a checkout holding ``chip_smoke.py`` and
``instancerefer_tpu_torch/``.  The step is the one that phase 7 of
``chip_smoke.py`` times (``train_step`` on a 32-scene synthetic batch at
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
- ``graph``: where ROOT has ``train/step_graph.py``, the same model's train
  and eval steps as CUDA graph replays (``train_wall_ms``,
  ``eval_wall_ms``), timed as ``wall_ms``; empty otherwise;
- ``kernels_ms``: CUDA-event medians of 10 launches of ROOT's wrappers on
  the same batch's maps, bf16 (ROOT's ``chip_smoke.median_ms``, the timer
  of the smoke's ``kernels`` line): K1 with its BN/ReLU epilogue at both
  stems, and K3 at both stems and every down conv of both encoders
  (``SHAPES``); the stems at Cin 7, 10 and 135, each fed the rows its main
  path gives it (a root with ``gather_conv.pad_channels`` pads the stems'
  rows before the timing, as ``ops/sparse_conv.stem_input`` does).

Then a table of the runs, per root the median of its runs' medians, and
per shape the median of each root's kernel times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PREFIX = "STEP_AB "
WIDTHS = (32, 64, 128, 128, 128)  # the encoders' channels by stage
STEM_CINS = (7, 10, 135)  # the stems' Cin: the default config, use_normal, use_multiview


def _shapes():
    """(label, wrapper, map key, key of the map whose rows are the input,
    Cin, Cout) of the K1 stems and of every K3 launch of a train step, and
    of the stems at the other input widths."""
    shapes = []
    for enc, p in (("scene", "scene"), ("instance", "inst")):
        for cin in STEM_CINS:
            stem = (f"{p}_nbr3_0", f"{p}_nbr3_0", cin, WIDTHS[0])
            tag = "" if cin == 7 else f" Cin {cin}"
            shapes += [(f"K1 {enc} stem{tag}", "gather_conv", *stem),
                       (f"K3 {enc} stem{tag}", "conv_dw", *stem)]
        shapes += [(f"K3 {enc} stage{s} down", "conv_dw", f"{p}_down_{s}", f"{p}_nbr3_{s - 1}",
                    WIDTHS[s - 1], WIDTHS[s]) for s in range(1, 5)]
    return shapes


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


def _time_kernels(batch, dev, median_ms) -> dict:
    """ROOT's K1 and K3 wrappers at ``SHAPES``, bf16, random inputs."""
    import numpy as np
    import torch

    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    gen = torch.Generator(device=dev).manual_seed(7)
    pad = getattr(G, "pad_channels", None)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    out = {}
    for label, wrapper, key, in_key, cin, cout in SHAPES:
        nbr = torch.from_numpy(np.ascontiguousarray(batch[key], np.int32)).to(dev)
        x = rnd(batch[in_key].shape[0], cin).bfloat16()
        if pad is not None and "stem" in label:
            x = pad(x)  # the rows the stem's main path gives it
        if wrapper == "gather_conv":
            w = (rnd(nbr.shape[1], cin, cout) / (nbr.shape[1] * cin) ** 0.5).bfloat16()
            sc, bi = 0.5 + torch.rand(cout, device=dev, generator=gen), 0.1 * rnd(cout)
            out[label] = median_ms(lambda: G.gather_conv(x, nbr, w, sc, bi, relu=True))
        else:
            g = rnd(nbr.shape[0], cout).bfloat16()
            kw = {"cin": cin} if pad is not None else {}
            out[label] = median_ms(lambda: conv_bwd.conv_dw(x, nbr, g, **kw))
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


def child(steps: int) -> dict:
    sys.path.insert(0, os.getcwd())  # ROOT's package and chip_smoke.py
    import gc

    import torch

    import chip_smoke as cs
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops import gather_conv
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    try:
        from instancerefer_tpu_torch.data.pipeline import BatchSpec
        from instancerefer_tpu_torch.data.synthetic import make_batch
    except ImportError:  # a checkout whose host bridge re-exports them
        from instancerefer_tpu_torch.data.host import BatchSpec, make_batch

    if not torch.cuda.is_available():
        raise SystemExit("step_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gather_conv.build()
    spec = BatchSpec(**cs.SPEC_KW)
    batch = make_batch(cs.BATCH, spec, seed=0, mean_size_arr=cs.MEAN_SIZE, **cs.SCENE_KW)
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
    prof = _profile(step, getattr(cs, "KERNEL_FAMILIES", ()))
    lang = _lang_profile(model.train(), dd, cs.median_ms)
    eval_wall = _walls(lambda: cs.run_slice(model.eval(), dd, mean_size), steps)
    graph = {}
    try:
        from instancerefer_tpu_torch.train.step_graph import StepGraphs
    except ImportError:  # a checkout whose steps run only eagerly
        StepGraphs = None
    if StepGraphs is not None:  # the same model and batch, replayed
        graphs = StepGraphs(model, opt, mean_size)
        graphs.train_step(dd)
        graphs.eval_step(dd)
        key = dd["lang_feat"].shape[1]
        t_in = graphs.graphs[graphs.key("train", key)].inputs
        e_in = graphs.graphs[graphs.key("eval", key)].inputs
        graph = {"train_wall_ms": _walls(lambda: graphs.train_step(t_in), steps),
                 "eval_wall_ms": _walls(lambda: graphs.eval_step(e_in), steps)}
    set_compute_dtype(None)
    kernels = _time_kernels(batch, dev, cs.median_ms)
    return {"wall_ms": wall, "host_ms": host, "cpu_ms": cpu, "gc_ms": in_gc[0] * 1e3,
            "probe_before": probe_before, "probe_after": probe_after, "load1": load1,
            "profile": prof, "lang": lang, "eval_wall_ms": eval_wall, "graph": graph,
            "kernels_ms": kernels}


def _order(roots, rounds: int):
    return [r for _ in range(rounds) for r in list(roots) + list(roots)[::-1]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkouts holding chip_smoke.py")
    ap.add_argument("--rounds", type=int, default=2, help="A B B A rounds")
    ap.add_argument("--steps", type=int, default=20, help="timed steps a run")
    ap.add_argument("--out", help="also append each run's record to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(PREFIX + json.dumps(child(args.steps)), flush=True)
        return
    if not args.roots:
        ap.error("give at least one ROOT")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for i, root in enumerate(_order([os.path.abspath(r) for r in args.roots], args.rounds)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--steps", str(args.steps)],
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
    print("kernel ms, bf16, median of each root's runs: " + ", ".join(
        os.path.basename(root) for root in roots))
    for label, *_ in SHAPES:
        print(f"  {label}: " + ", ".join(
            f"{med(r['kernels_ms'][label] for r in runs if r['root'] == root):.4f}"
            for root in roots))


if __name__ == "__main__":
    main()
