"""The sparse encoders' fused masked BatchNorm (``ops/masked_bn``).

On the CPU the Function runs its plain twin, held here against autograd of
the unfused train path it replaced (``reference``: ``MaskedBatchNorm``'s
statistics and normalization, then the residual add and the ReLU as
separate ops): y, dx, dweight, dbias, the residual's gradient, the running
statistics and ``num_batches_tracked``, over masks of none, random and no
rows, with and without the residual, in f32 and in bf16 with
|mean| >> std.  A train forward of the model calls it at the encoders' 26
BN sites (the ReLU at 18, the residual add at 8) and an eval forward at
none; the kernels' names match none of the sparse-conv patterns that the
launch counters are held against.

On the card (``@pytest.mark.gpu``, skipped without one; this file imports
no JAX, so ``python -m pytest tests/test_torch_masked_bn.py -m gpu
--noconftest`` runs them there): the kernels against the twin at the
encoders' widths (row counts not a multiple of a block's rows, ragged
masks), bit-identical on a second launch; a capture and replays as a CUDA
graph with the momentum changed between replays; the launch counters at
26 forward and 26 backward calls a train step, replays included, and none
an eval step; the profiler's names of the kernels.
The reference runs in f32 on the values of the inputs: in bf16 the fused
path adds the residual in f32 and rounds once, where the unfused one
rounded BN(x) first, so an output within a rounding of 0 could take the
other side of the ReLU.  Tolerances: f32 within 1e-4 of the largest value
(sums in another order); bf16 outputs within 1e-2 (one bf16 rounding of
the same f32 value) and its f32 sums within 1e-3.
"""

import os
import re

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.models import basic_blocks
from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.ops import masked_bn as M
from instancerefer_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
EPS = 1e-5


def reference(x, mask, weight, bias, running_mean, running_var, momentum, residual):
    """The encoders' train path before the fusion: ``MaskedBatchNorm.
    _normalize`` (channels last), then ``h + residual`` and ``relu`` as ops
    of their own, in x's dtype; autograd differentiates it."""
    flat = x.float()
    if mask is None:
        n = flat.new_full((), float(flat.shape[0]))
        mean = flat.mean(0)
        var = flat.square().mean(0) - mean.square()
    else:
        rows = mask.reshape(-1, 1).float()
        n = rows.sum().clamp(min=1.0)
        mean = (flat * rows).sum(0) / n
        var = (flat.square() * rows).sum(0) / n - mean.square()
    var = var.clamp(min=0.0)
    with torch.no_grad():
        m = momentum
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        running_mean.copy_((1.0 - m) * running_mean + m * mean)
        running_var.copy_((1.0 - m) * running_var + m * unbiased)
    inv = torch.rsqrt(var + EPS) * weight
    y = ((x.float() - mean) * inv + bias).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y)


def _inputs(rows, c, dtype, mask_kind, seed=0, device="cpu", offset=0.0, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=gen) * scale + offset).to(dtype)
    r = torch.randn(rows, c, generator=gen).to(dtype)
    dy = torch.randn(rows, c, generator=gen).to(dtype)
    mask = {"none": None, "random": torch.rand(rows, generator=gen) < 0.6,
            "empty": torch.zeros(rows, dtype=torch.bool)}[mask_kind]
    weight = torch.rand(c, generator=gen) + 0.5
    bias = torch.randn(c, generator=gen) * 0.1
    out = [x, r, dy, mask, weight, bias]
    return [None if t is None else t.to(device) for t in out]


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    top = want.abs().max().item() if want.numel() else 0.0
    assert err <= tol * max(top, 1e-6), f"{what}: max |err| {err:.3e}, max |want| {top:.3e}"


def _run_pair(x, r, dy, mask, weight, bias, residual, momentum):
    """(the fused module's results, the reference's) from one state; the
    reference runs in f32 on the same values."""
    results = []
    for fused in (True, False):
        if not fused:  # the reference in f32, over the same values
            x, r, dy = x.float(), r.float(), dy.float()
        bn = MaskedBatchNorm(x.shape[1]).to(x.device).train()
        bn.momentum = momentum
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
            bn.running_mean.uniform_(-1, 1, generator=torch.Generator().manual_seed(2))
        xi = x.clone().requires_grad_(True)
        ri = r.clone().requires_grad_(True) if residual else None
        if fused:
            y = bn.fused(xi, mask, residual=ri)
        else:
            y = reference(xi, mask, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                          bn.batch_momentum, ri)
            bn.num_batches_tracked += 1
        y.backward(dy)
        results.append({"y": y.detach(), "dx": xi.grad, "dweight": bn.weight.grad,
                        "dbias": bn.bias.grad, "dres": None if ri is None else ri.grad,
                        "running_mean": bn.running_mean, "running_var": bn.running_var,
                        "tracked": bn.num_batches_tracked})
    return results


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "random", "empty"])
def test_twin_equals_autograd_of_the_unfused_path(mask_kind, residual, dtype):
    # bf16: |mean| >> std, where E[x^2] - mean^2 cancels (f32 sums)
    offset, scale = (50.0, 2.0) if dtype == torch.bfloat16 else (0.3, 1.5)
    x, r, dy, mask, weight, bias = _inputs(203, 32, dtype, mask_kind, offset=offset,
                                           scale=scale)
    got, want = _run_pair(x, r, dy, mask, weight, bias, residual, 0.3)
    tol = TOL[dtype]
    for key in ("y", "dx", "dres"):
        if want[key] is None:
            assert got[key] is None, key
            continue
        assert got[key].dtype == dtype, key
        _close(got[key], want[key], tol, key)
    for key in ("dweight", "dbias", "running_mean", "running_var"):
        _close(got[key], want[key], 1e-4 if dtype == torch.float32 else 1e-3, key)
    assert int(got["tracked"]) == int(want["tracked"]) == 1


def test_clamped_variance_drops_the_xh_term():
    """A constant column whose E[x^2] - mean^2 rounds below 0: its variance
    clamps to 0, and the gradient through the variance drops with it, as
    the clamp's gradient does in the unfused path."""
    x, r, dy, mask, weight, bias = _inputs(64, 32, torch.float32, "random", seed=3)
    x[:, 5] = 0.1
    got, want = _run_pair(x, r, dy, mask, weight, bias, False, 0.1)
    for key in ("y", "dx", "dweight", "dbias", "running_var"):
        _close(got[key], want[key], 1e-4, key)


def test_train_forward_calls_the_fused_path_at_the_encoders_26_sites(monkeypatch):
    calls = []
    real = basic_blocks.masked_bn

    def count(x, mask, weight, bias, running_mean, running_var, momentum, eps, residual):
        calls.append((x.shape[1], residual is not None))
        return real(x, mask, weight, bias, running_mean, running_var, momentum, eps, residual)

    monkeypatch.setattr(basic_blocks, "masked_bn", count)
    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0))
    dd = batch_to_torch(make_batch(2, TEST_SPEC, seed=0, mean_size_arr=MEAN_SIZE), TEST_SPEC,
                        "cpu")
    model.train()(dd)
    assert len(calls) == 26
    assert sum(res for _, res in calls) == 8
    assert sorted({c for c, _ in calls}) == [32, 64, 128]
    calls.clear()
    with torch.no_grad():
        model.eval()(dd)
    assert calls == []


def test_kernel_names_match_no_sparse_conv_pattern():
    """The launch counters are held against the profiler's kernels by name
    (``utils/profiling``, the benchmark's copy): no masked BN kernel may
    read as a sparse-conv one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_kernel_names", os.path.join(ROOT, "benchmark", "metrics", "_kernel_names.py"))
    B = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(B)

    src = open(os.path.join(ROOT, "instancerefer_tpu_torch", "csrc", "masked_bn.cu")).read()
    kernels = sorted(set(re.findall(r"\b(masked_bn_\w+_kernel)\b", src)))
    assert len(kernels) == 6
    for name in kernels:
        for args in ("", "<__nv_bfloat16, 32>", "<float, 128>", "<64>"):
            full = f"void irbn::{name}{args}(float const*, int, bool, float*)"
            for first in (P.LAUNCH_FIRST, B.LAUNCH_FIRST):
                assert not any(p.search(full) for p in first.values()), full
            assert not P.LAUNCH_REST.search(full) and not B.LAUNCH_REST.search(full), full
            assert P.family_of(full) is None and not B.is_sparse(full), full


def test_cpu_launches_no_kernel_and_cuda_checks_refuse_bad_inputs():
    x, r, dy, mask, weight, bias = _inputs(10, 48, torch.float32, "random")
    bn = MaskedBatchNorm(48).train()
    before = (M.masked_bn.launches, M.masked_bn.bwd_launches)
    xi = x.clone().requires_grad_(True)
    bn.fused(xi, mask).backward(dy)  # the twin takes any width on the CPU
    assert (M.masked_bn.launches, M.masked_bn.bwd_launches) == before
    with pytest.raises(ValueError, match="mask"):
        bn.fused(x, mask[:5])
    with pytest.raises(ValueError, match="residual"):
        bn.fused(x, mask, residual=r.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        bn.fused(x.t().contiguous().t(), mask)


@pytest.mark.parametrize("rows,c,dtype,pass_,per_row,sms,want", [
    (1163264, 32, torch.bfloat16, "fwd", True, 132, 528),  # the scene stem: 4 a SM
    (100, 128, torch.bfloat16, "fwd", True, 132, 2),  # 16 rows a sweep, 4 sweeps a step
    (0, 64, torch.bfloat16, "bwd", True, 132, 1),
    (16384, 128, torch.bfloat16, "bwd", False, 132, 512),  # 262144 vectors / (256 x 2)
    (16384, 128, torch.float32, "fwd", False, 100, 400),  # 524288 / 1024, at most 4 x 100
    (16384, 128, torch.float32, "bwd", True, 132, 528),  # 8 rows a sweep, 2 sweeps: 1024
])
def test_blocks_follow_the_shape_and_the_card(rows, c, dtype, pass_, per_row, sms, want):
    assert M.blocks(rows, c, dtype, pass_, sms, per_row) == want


# --- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fused_on(device, x, r, dy, mask, weight, bias, residual, momentum, running, eps=EPS):
    def leaf(t):
        return t.detach().to(device).clone().requires_grad_(True)

    xi, w, b = leaf(x), leaf(weight), leaf(bias)
    ri = leaf(r) if residual else None
    rm, rv = (t.to(device).clone() for t in running)
    m = torch.tensor(momentum, device=device)
    y = M.masked_bn(xi, None if mask is None else mask.to(device), w, b, rm, rv, m, eps, ri)
    y.backward(dy.to(device))
    out = {"y": y.detach(), "dx": xi.grad, "dweight": w.grad, "dbias": b.grad,
           "dres": None if ri is None else ri.grad, "running_mean": rm, "running_var": rv}
    return {k: None if v is None else v.cpu() for k, v in out.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c,mask_kind,residual", [
    (18176 * 2 + 7, 32, "random", False),  # a stem: rows not a multiple of a sweep
    (4352 * 2 + 3, 64, "random", True),
    (1280 * 2 + 1, 128, "random", False),
    (517, 128, "none", True),
    (255, 64, "empty", False),
    (1000, 32, "random", True),
])
def test_kernels_equal_the_twin_on_card(card, rows, c, mask_kind, residual, dtype):
    x, r, dy, mask, weight, bias = _inputs(rows, c, dtype, mask_kind, seed=rows, offset=0.5)
    running = (torch.randn(c) * 0.1, torch.rand(c) + 0.5)
    want = _fused_on("cpu", x, r, dy, mask, weight, bias, residual, 0.2, running)
    before = (M.masked_bn.launches, M.masked_bn.bwd_launches)
    got = _fused_on(card, x, r, dy, mask, weight, bias, residual, 0.2, running)
    again = _fused_on(card, x, r, dy, mask, weight, bias, residual, 0.2, running)
    torch.cuda.synchronize()
    assert (M.masked_bn.launches, M.masked_bn.bwd_launches) == (before[0] + 2, before[1] + 2)
    for key, g in got.items():
        if g is None:
            assert want[key] is None
            continue
        assert torch.equal(g, again[key]), f"{key}: a second launch differs"
        tol = TOL[dtype] if key in ("y", "dx", "dres") else 1e-4
        _close(g, want[key], tol, key)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [16, 48, 80, 96, 112, 160, 192])
def test_kernels_equal_the_twin_at_pointgroup_widths_on_card(card, c, dtype):
    """PointGroup's U-Net widths (m = 16: 16-112 and the tails' 2m-192,
    several of which leave a block's last threads without rows) at its eps
    1e-4, in the pre-activation form (no residual) and with one.  Each
    pass is held against its twin from the same inputs: the backward's
    twin takes the kernels' own y and statistics, since over millions of
    f32 elements a few y within a rounding of 0 take the other side of the
    ReLU when the statistics are summed in another order."""
    for rows, residual in ((60001, False), (333, True)):
        x, r, dy, mask, weight, bias = _inputs(rows, c, dtype, "random", seed=rows + c,
                                               offset=0.5)
        res = r if residual else None
        got, want = [], []
        for dev, plain, out in ((card, False, got), ("cpu", True, want)):
            def on(t):
                return None if t is None else t.to(dev)
            rm = torch.linspace(-0.1, 0.1, c, device=dev)
            rv = torch.linspace(0.5, 1.5, c, device=dev)
            y, stat = M.forward_passes(on(x), on(mask), on(weight), on(bias), on(res), rm, rv,
                                       torch.tensor(0.1, device=dev), 1e-4, plain)
            if not plain:
                y_card, stat_card = y, stat
            grads = M.backward_passes(on(dy), on(y_card), on(x), on(mask), on(stat_card),
                                      residual, plain)
            out.append({"y": y, "stat": stat, "running_mean": rm, "running_var": rv,
                        **dict(zip(("dx", "dweight", "dbias", "dres"), grads))})
        for key, g in got[0].items():
            if g is None:
                assert want[0][key] is None
                continue
            tol = TOL[dtype] if key in ("y", "dx", "dres") else 1e-4
            _close(g.cpu(), want[0][key].cpu(), tol, key)


@pytest.mark.gpu
def test_capture_and_replay_follow_the_momentum_on_card(card):
    rows, c = 9000, 64
    x, r, dy, mask, weight, bias = _inputs(rows, c, torch.bfloat16, "random", seed=7)
    xs, rs, gys, ms = (t.to(card) for t in (x, r, dy, mask))
    xs.requires_grad_(True)
    rs.requires_grad_(True)
    w = weight.to(card).requires_grad_(True)
    b = bias.to(card).requires_grad_(True)
    rm, rv = torch.zeros(c, device=card), torch.ones(c, device=card)
    mom = torch.tensor(0.1, device=card)

    def body():
        y = M.masked_bn(xs, ms, w, b, rm, rv, mom, EPS, rs)
        return (y,) + torch.autograd.grad(y, (xs, w, b, rs), gys)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up: the library's first launch
    torch.cuda.current_stream().wait_stream(side)
    counts = (M.masked_bn.launches, M.masked_bn.bwd_launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    assert (M.masked_bn.launches, M.masked_bn.bwd_launches) == (counts[0] + 1, counts[1] + 1)
    cpu_rm, cpu_rv = torch.zeros(c), torch.ones(c)
    # the warm-up moved the running statistics at 0.1; the capture ran nothing
    _replay_reference(x, r, dy, mask, weight, bias, cpu_rm, cpu_rv, 0.1)
    for momentum in (0.5, 0.9):
        mom.fill_(momentum)
        graph.replay()
        want = _replay_reference(x, r, dy, mask, weight, bias, cpu_rm, cpu_rv, momentum)
        torch.cuda.synchronize()
        for key, g in zip(("y", "dx", "dweight", "dbias", "dres"), outs):
            tol = TOL[torch.bfloat16] if key in ("y", "dx", "dres") else 1e-4
            _close(g.cpu(), want[key], tol, f"{key} at momentum {momentum}")
        _close(rm.cpu(), cpu_rm, 1e-4, "running_mean")
        _close(rv.cpu(), cpu_rv, 1e-4, "running_var")


def _replay_reference(x, r, dy, mask, weight, bias, rm, rv, momentum):
    xi, ri = x.clone().requires_grad_(True), r.clone().requires_grad_(True)
    w, b = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    y = M.masked_bn(xi, mask, w, b, rm, rv, torch.tensor(momentum), EPS, ri)
    y.backward(dy)
    return {"y": y.detach(), "dx": xi.grad, "dweight": w.grad, "dbias": b.grad, "dres": ri.grad}


@pytest.mark.gpu
def test_launch_counters_read_26_calls_a_train_step_and_none_an_eval_step_on_card(card):
    from instancerefer_tpu_torch.train import solver as S
    from instancerefer_tpu_torch.train import step_graph as G

    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0)).to(card)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=card)
    graphs = G.StepGraphs(model, S.make_optimizer(model.parameters(), 1e-3, 1e-5), ms)
    dd = batch_to_torch(make_batch(2, TEST_SPEC, seed=0, mean_size_arr=MEAN_SIZE), TEST_SPEC,
                        card)
    reads = []
    for step in (graphs.train_step, graphs.train_step, graphs.train_step, graphs.eval_step,
                 graphs.eval_step):
        before = (M.masked_bn.launches, M.masked_bn.bwd_launches)
        step(dd)
        torch.cuda.synchronize()
        reads.append((M.masked_bn.launches - before[0], M.masked_bn.bwd_launches - before[1]))
    # train: the warm-up (eager), then two replays; eval: its warm-up and a replay
    assert graphs.captures == 2 and graphs.replays >= 3
    assert reads == [(26, 26)] * 3 + [(0, 0)] * 2


@pytest.mark.gpu
def test_profiled_kernel_names_match_no_sparse_conv_pattern_on_card(card):
    from torch.profiler import ProfilerActivity, profile

    x, r, dy, mask, weight, bias = _inputs(4096, 64, torch.bfloat16, "random")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _fused_on(card, x, r, dy, mask, weight, bias, True, 0.1,
                  (torch.zeros(64), torch.ones(64)))
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events() if "masked_bn" in ev.name}
    found = {re.search(r"masked_bn_\w+_kernel", n).group(0) for n in names}
    assert found == {"masked_bn_stats_kernel", "masked_bn_finalize_kernel",
                     "masked_bn_apply_kernel", "masked_bn_bwd_reduce_kernel",
                     "masked_bn_total_kernel", "masked_bn_bwd_apply_kernel"}, names
    for name in names:
        assert not any(p.search(name) for p in P.LAUNCH_FIRST.values()), name
        assert not P.LAUNCH_REST.search(name) and P.family_of(name) is None, name
