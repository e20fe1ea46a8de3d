"""The port's spans and the readers over them (``utils/profiling``), on the
CPU:

* ``span`` is one shared no-op while no profiler records, and a
  ``record_function`` that also logs its host time while one does;
* under ``torch.profiler``, steps through ``StepGraphs`` (an eager warm-up,
  then a replay through ``EagerGraph``, which runs the body as the card's
  capture does) record every span of the host step path and of the modules,
  each inside the span it belongs to;
* every backward node of an eager train step maps to the spans of its
  forward op by sequence number, and ``attribute`` charges every op;
* ``StepGraphs.replays`` counts replays, not warm-ups or captures;
* the idle arithmetic: gaps split between the spans the host was in, the
  rest ``between steps``; a profiled window retaken until its launches agree
  with the counters (a stand-in profiler: the CPU has no device records);
* the benchmark's ``host_issue_ms`` readers over the program's span log,
  and its rehearsal, which prints them null.

This file imports no JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instancerefer_tpu_torch.data.host import batch_to_torch, stage
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train import solver as S
from instancerefer_tpu_torch.train import step_graph as G
from instancerefer_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
# each span of a replayed or eager train step, and the span it lies in
# (None: a top-level span; ir.bn lies in a module's forward)
PARENT = {
    "ir.load": None, "ir.load.sources": "ir.load", "ir.load.copy": "ir.load",
    "ir.step": None, "ir.step.mode": "ir.step", "ir.step.capture": "ir.step",
    "ir.step.replay": "ir.step", "ir.step.clone": "ir.step",
    "ir.fwd.lang": "body", "ir.fwd.attribute": "body", "ir.fwd.relation": "body",
    "ir.fwd.scene": "body", "ir.loss": "body", "ir.backward": "body", "ir.adam": "body",
    "ir.eval": "body", "ir.bn": "module",
    "ir.to_host": None, "ir.to_host.issue": "ir.to_host", "ir.to_host.wait": "ir.to_host",
}
BODY = ("ir.step.capture", "ir.step.replay")
MODULES = ("ir.fwd.attribute", "ir.fwd.relation", "ir.fwd.scene")


class EagerGraph:
    """A CUDA graph's stand-in that runs the body at its capture, as a
    capture runs the Python, and again at each replay."""

    def capture(self, fn):
        self.fn = fn
        return fn()

    def replay(self):
        return self.fn()


class CountingGraph(EagerGraph):
    made = 0

    def __init__(self):
        CountingGraph.made += 1


def _model(seed=0):
    return InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                         generator=torch.Generator().manual_seed(seed))


def _graphs(new_graph=EagerGraph):
    model = _model()
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    return G.StepGraphs(model, S.make_optimizer(model.parameters(), 1e-3, 1e-5), ms,
                        new_graph=new_graph)


def _batch(seed=0):
    return make_batch(2, TEST_SPEC, seed=seed, mean_size_arr=MEAN_SIZE)


def _steps(graphs, n, phase="train"):
    """``n`` steps as the solver and the benchmark run them: load, step,
    metrics to the host."""
    for i in range(n):
        dd = graphs.load(stage(_batch(i), TEST_SPEC), TEST_SPEC, phase)
        step = graphs.train_step if phase == "train" else graphs.eval_step
        S.metrics_to_host(step(dd)[0], i)


@pytest.fixture(scope="module")
def traced():
    """Two train steps through the graph path (the warm-up and capture,
    then a replay) under the CPU profiler: (the host ops, their parents)."""
    graphs = _graphs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(graphs, 2)
    ops = P.host_ops(prof.events())
    return ops, P._parents(ops)


def test_span_is_the_shared_no_op_without_a_profiler():
    assert P.span("ir.step") is P.NO_SPAN and P.span("ir.load", step=3) is P.NO_SPAN
    with P.span("ir.step") as inside:
        assert inside is None
    before = len(P.SPAN_LOG)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = P.span("ir.step", step=7)
        assert on is not P.NO_SPAN
        with on:
            time.sleep(0.002)
    assert P.span("ir.step") is P.NO_SPAN
    assert len(P.SPAN_LOG) == before + 1
    name, seconds = P.SPAN_LOG[-1]
    assert name == "ir.step" and seconds >= 0.002
    assert [ev.name for ev in prof.events() if ev.name.startswith("ir.")] == ["ir.step"]


def _span_parent(op, parents):
    p = parents.get(op.id)
    while p is not None and not p.name.startswith(P.SPAN_PREFIX):
        p = parents.get(p.id)
    return None if p is None else p.name


def test_train_steps_record_every_span_nested(traced):
    ops, parents = traced
    spans = [op for op in ops if op.name.startswith(P.SPAN_PREFIX)]
    assert {op.name for op in spans} == set(PARENT)
    for op in spans:
        want, got = PARENT[op.name], _span_parent(op, parents)
        if want == "body":
            assert got in BODY, (op.name, got)
        elif want == "module":
            assert got in MODULES, (op.name, got)
        else:
            assert got == want, (op.name, got)
    count = {name: sum(op.name == name for op in spans) for name in PARENT}
    # the first step warms up and captures, the second replays; every step
    # loads, steps, clones and reads back once; the body runs in the
    # warm-up, the capture and the replay, Adam zeroing and stepping in each
    assert count["ir.step.capture"] == count["ir.step.replay"] == 1
    assert all(count[n] == 2 for n in ("ir.load", "ir.step", "ir.step.clone", "ir.to_host"))
    assert all(count[n] == 3 for n in ("ir.fwd.scene", "ir.loss", "ir.backward", "ir.eval"))
    assert count["ir.adam"] == 6


def test_every_backward_node_maps_to_a_module_by_sequence_number(traced):
    ops, _ = traced
    forward = P.forward_spans(ops)
    nodes = [op for op in ops if op.name.startswith(P.BACKWARD_OP)]
    with_forward = [op for op in nodes if "AccumulateGrad" not in op.name]
    assert len(with_forward) > 100
    for node in with_forward:
        chain = forward.get((node.fwd_thread, node.seq))
        assert chain and chain[-2 if chain[-1] == "ir.bn" else -1] in (
            "ir.fwd.lang", "ir.loss") + MODULES, (node.name, chain)
    # gradient accumulation has no forward op: charged to the backward's span
    charged = P.attribute(ops)
    assert all(chain for op, chain, _ in charged if op.name.startswith(P.BACKWARD_OP))
    assert {chain[-1] for op, chain, side in charged
            if "AccumulateGrad" in op.name and side == "backward"} == {"ir.backward"}


def test_replays_count_replays_not_warm_ups_or_captures():
    CountingGraph.made = 0
    graphs = _graphs(CountingGraph)
    _steps(graphs, 3)
    assert (CountingGraph.made, graphs.captures, graphs.replays, graphs.steps) == (1, 1, 2, 3)
    _steps(graphs, 2, "eval")
    assert (CountingGraph.made, graphs.captures, graphs.replays, graphs.steps) == (2, 2, 3, 5)
    # the last step's split: a replay's own marks, forward, eval
    assert len(graphs.phase_seconds()) == 2 and min(graphs.phase_seconds()) > 0


def test_step_marks_time_each_replay_anew(monkeypatch):
    """A replay's split is its own: a backward slowed by 40 ms in the second
    replay reads so there and not in the first."""
    graphs = _graphs()
    _steps(graphs, 2)
    first = graphs.phase_seconds()
    real = G.train_metrics

    def slow(out):
        time.sleep(0.04)
        return real(out)

    monkeypatch.setattr(G, "train_metrics", slow)
    _steps(graphs, 1)
    second = graphs.phase_seconds()
    assert len(first) == len(second) == 3
    assert first[2] < 0.04 <= second[2]


def test_idle_split_between_spans():
    device = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0), ("d", 60.0, 70.0)]
    busy, gaps = P.busy_and_gaps(device)
    assert busy == 40.0 and [(a, b) for a, b, _, _ in gaps] == [(20.0, 30.0), (40.0, 60.0)]
    spans = [("ir.step", 0.0, 25.0), ("ir.step.replay", 2.0, 24.0),
             ("ir.to_host", 26.0, 50.0), ("ir.to_host.wait", 28.0, 45.0)]
    segs = P.segments(spans)
    assert P.chain_at(segs, 23.0) == ("ir.step", "ir.step.replay")
    assert P.chain_at(segs, 25.5) == () and P.chain_at(segs, 100.0) == ()
    idle = P.idle_by_span(gaps, segs)
    assert idle == {"ir.step.replay": 4.0, "ir.step": 1.0, P.BETWEEN: 1.0 + 10.0,
                    "ir.to_host": 2.0 + 5.0, "ir.to_host.wait": 7.0}
    assert sum(idle.values()) == sum(b - a for a, b, _, _ in gaps)


def test_a_window_is_retaken_until_its_launches_agree(monkeypatch):
    """``profile_agreeing`` on the CPU: the stand-in device records of each
    window lose one K1 launch in the first window (and in every window in
    the second case), while the counters add 2."""
    windows = []

    def records(losses):
        def device(events):
            lost = losses[min(len(windows), len(losses) - 1)]
            windows.append(lost)
            names = ["gather_gemm_tc_kernel<bf16, 128, false>"] * (2 - lost)
            return [(n, float(i), i + 0.5) for i, n in enumerate(names)]
        return device

    def run():
        G.gather_conv.launches += 2

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(P, "_device_records", records([1, 0]))
    _, _, rec = P.profile_agreeing(run)
    assert rec["agrees"] and rec["windows"] == 2 and rec["why"] is None
    assert rec["seen"] == rec["counted"] == {"K1": 2, "K2": 0, "K3": 0, "L": 0, "UP": 0}
    windows.clear()
    logged = []
    monkeypatch.setattr(P, "_device_records", records([1]))
    _, _, rec = P.profile_agreeing(run, log=logged.append)
    assert not rec["agrees"] and rec["windows"] == P.PROFILE_TRIES == len(windows) == 3
    assert "window 3 of 3" in rec["why"] and len(logged) == 3


def _metric(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_host_issue_ms_reads_the_windows_steps(phase, monkeypatch):
    graphs = _graphs()
    _steps(graphs, 1, phase)  # the warm-up, outside the window
    P.SPAN_LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        _steps(graphs, 3, phase)
        wall = time.perf_counter() - t0
    reader = _metric(f"host_issue_ms.{phase}")
    record = {"phase": phase, "profile": {"steps": 3}}
    got = reader.read(record)
    spent = {n: sum(s for name, s in P.SPAN_LOG if name == n)
             for n in ("ir.load", "ir.step", "ir.to_host", "ir.to_host.wait")}
    assert got == pytest.approx(1e3 * (spent["ir.load"] + spent["ir.step"] + spent["ir.to_host"]
                                       - spent["ir.to_host.wait"]) / 3)
    assert 0 < got < 1e3 * wall / 3
    assert reader.read({"phase": "train" if phase == "eval" else "eval",
                        "profile": {"steps": 3}}) is None
    assert reader.read({**record, "profile": {"steps": 10 ** 6}}) is None
    monkeypatch.delattr(P, "SPAN_LOG")  # a program without spans
    assert reader.read(record) is None


@pytest.mark.parametrize("cell", ["xyzrgbh-train-resident", "xyzrgbh-eval-resident"])
def test_rehearsal_prints_the_span_metrics_null(cell):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                           "2147483905", "--seconds", "1", "--trace", "1", "--rehearse"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])["metrics"]
    name = "host_issue_ms." + ("train" if "train" in cell else "eval")
    assert metrics[name] == {"value": None, "unit": "ms"}


def test_module_split_charges_an_eager_step(monkeypatch):
    """``attribute`` over an eager train step (``train_body``) charges every
    op that a step body runs to a span: the forward modules, the loss,
    Adam, eval and the backward's."""
    graphs = _graphs()
    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    graphs.model.train()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        G.train_body(graphs.model, graphs.optimizer, dd, graphs.mean_size, set_to_none=False)
    charged = P.attribute(P.host_ops(prof.events()))
    tops = {chain[0] for _, chain, _ in charged if chain}
    assert tops == {"ir.fwd.lang", "ir.fwd.attribute", "ir.fwd.relation", "ir.fwd.scene",
                    "ir.loss", "ir.backward", "ir.adam", "ir.eval"}
    aten = [op for op, chain, _ in charged if op.name.startswith("aten::")]
    assert aten and all(chain for op, chain, _ in charged if op.name.startswith("aten::"))
    assert {side for op, _, side in charged if op.name.startswith(P.BACKWARD_OP)} == {"backward"}


def _event(name, start, end, corr=0, thread=1, device=False, seq=-1, fwd_thread=0,
           annotation=False):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, id=corr, thread=thread, fwd_thread=fwd_thread,
                           sequence_nr=seq, is_async=False, is_user_annotation=annotation,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_records_are_charged_through_their_runtime_calls():
    """A stand-in profile: a kernel launched inside a forward op, the kernel
    of its backward on the autograd engine's thread, a launch the profiler
    could not tie to any op (charged by time), a record whose call was lost,
    and an annotation's device range (left out)."""
    events = [
        _event("ir.fwd.scene", 0, 100, corr=1), _event("ir.backward", 200, 400, corr=2),
        _event("aten::mul", 10, 50, corr=3, seq=5),
        _event("cudaLaunchKernel", 20, 25, corr=900),
        _event("gather_gemm_tc_kernel<bf16, 128, false>", 30, 40, corr=900, device=True),
        _event(P.BACKWARD_OP + ": MulBackward0", 250, 300, corr=4, thread=2, seq=5,
               fwd_thread=1),
        _event("aten::mul", 255, 290, corr=5, thread=2),
        _event("cudaLaunchKernel", 260, 262, corr=901, thread=2),
        _event("elementwise_kernel", 270, 280, corr=901, device=True),
        _event("cudaLaunchKernel", 60, 61, corr=902, thread=77),
        _event("reduce_kernel", 65, 70, corr=902, device=True),
        _event("Memset (Device)", 410, 420, corr=999, device=True),
        _event("ir.fwd.scene", 0, 100, corr=1, device=True, annotation=True),
    ]
    split = P.charge_device(events)
    assert split["modules"] == {"ir.fwd.scene": {"forward": 15.0, "backward": 10.0}}
    assert (split["device_us"], split["sparse_us"]) == (35.0, 10.0)


def test_device_profile_splits_its_window_idle_by_span(monkeypatch):
    """``device_profile`` on the CPU with a stand-in device: one kernel in
    the middle half of each call, which runs ``ir.step`` and then
    ``ir.to_host``.  The idle time by span sums to the calls' window less
    the busy time, and each call's idle falls under its two spans."""
    def device(events):
        calls = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                       if ev.name == P.CALL)
        return [("gather_gemm_tc_kernel<bf16, 128, false>", a + (b - a) / 4, a + (b - a) / 2)
                for a, b in calls]

    def fn():
        with P.span("ir.step"):
            time.sleep(0.004)
        with P.span("ir.to_host"):
            time.sleep(0.004)
        G.gather_conv.launches += 1

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(P, "_device_records", device)
    prof = P.device_profile(fn, 3)
    assert prof["agrees"] and prof["windows"] == 1
    idle = prof["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(prof["calls_ms"] - prof["device_busy_ms"])
    assert idle["ir.step"] > 0 and idle["ir.to_host"] > 0
    assert prof["idle_gaps"][0][4] in ("ir.step", "ir.to_host", P.BETWEEN)
