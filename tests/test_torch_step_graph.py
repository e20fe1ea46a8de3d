"""The port's steps as CUDA graphs (``instancerefer_tpu_torch/train/step_graph``).

On the CPU:

* the train and eval step bodies at ``TEST_SPEC``, under a
  ``TorchDispatchMode``, make none of the calls that read a value back to
  the host or give a shape from the data (``FORBIDDEN``; ``aten.index`` with
  a bool index).  Adam's own step runs outside the mode: on the CPU it reads
  its step count on the host, while on the card ``make_optimizer`` makes it
  capturable, and the card tests capture it.
* the graph cache through a fake capture (``EagerGraph``: the capture keeps
  the body, a replay runs it): one graph per (train or eval, language grid,
  compute dtype), a key's first batch runs eagerly and is not replayed, the
  later ones replay; ``load`` writes a batch into its graph's inputs, a
  caller's own data dict is copied and never written; a checkpoint load
  drops every graph.
* the launch counters under replay, through ``CountingGraph``, which, as a
  CUDA graph, runs Python only at the capture.
* a tensor lr under ``make_scheduler``'s MultiStepLR against the float lr,
  over 3 epochs; a checkpoint carries the lr and Adam's state between the
  two kinds.
* the solver picks the eager path on the CPU and logs it.

On the card (``@pytest.mark.gpu``, skipped without one; this file imports
no JAX, so ``python -m pytest tests/test_torch_step_graph.py -m gpu
--noconftest`` runs them there): graph replays against eager steps in f32
from the same state, the launch counts under replay, and a batch of
another language grid capturing its own graph.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from instancerefer_tpu_torch.data.host import batch_to_torch, stage, stage_to
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.ops import conv_bwd, gather_conv
from instancerefer_tpu_torch.ops.masked_bn import masked_bn
from instancerefer_tpu_torch.ops.precision import set_compute_dtype
from instancerefer_tpu_torch.train import solver as S
from instancerefer_tpu_torch.train import step_graph as G

aten = torch.ops.aten
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
# a device -> host read, or an output whose shape follows the data
FORBIDDEN = {aten._local_scalar_dense, aten.nonzero, aten._pack_padded_sequence,
             aten.masked_select, aten.bincount, aten.repeat_interleave}


def _batch(seed=0, grid=None):
    """A 2-scene batch at ``TEST_SPEC`` (T = 24), or cut to the language
    grid ``grid``."""
    batch = make_batch(2, TEST_SPEC, seed=seed, mean_size_arr=MEAN_SIZE)
    if grid is not None:
        batch["lang_feat"] = np.ascontiguousarray(batch["lang_feat"][:, :grid])
        batch["lang_len"] = np.minimum(batch["lang_len"], grid)
    return batch


def _model(seed=0, **kw):
    return InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                         generator=torch.Generator().manual_seed(seed), **kw)


class Forbidden(TorchDispatchMode):
    """Records every forbidden call made under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if func.overloadpacket in FORBIDDEN or "unique" in name:
            self.seen.append(name)
        elif func.overloadpacket is aten.index and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.seen.append(f"{name} with a bool index")
        return func(*args, **(kwargs or {}))


class Unobserved:
    """An optimizer whose ``step`` runs outside the dispatch mode."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self):
        with _disable_current_modes():
            self.optimizer.step()


def test_step_bodies_make_no_host_read_and_no_data_shape():
    model = _model().train()
    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    opt = Unobserved(S.make_optimizer(model.parameters(), 1e-3, 1e-5))
    with Forbidden() as mode:
        metrics, out = G.train_body(model, opt, dd, ms)
        model.eval()
        G.eval_body(model, dd, ms)
    assert mode.seen == []
    assert torch.isfinite(metrics["loss"]) and out["ref_iou"].shape == (2,)
    assert all(p.grad is not None for p in model.parameters())
    # the mode does see what it forbids
    with Forbidden() as mode:
        torch.tensor([1.0, 0.0]).nonzero()
        torch.ones(3)[torch.tensor([True, False, True])].sum().item()
    assert {"aten::nonzero", "aten::index.Tensor with a bool index",
            "aten::_local_scalar_dense"} <= set(mode.seen)


class EagerGraph:
    """A stand-in for ``CudaGraph`` on the CPU: the capture keeps the body
    without running it, a replay runs it."""

    def capture(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        return self.fn()


class CountingGraph:
    """As a CUDA graph, Python runs at the capture only: the capture runs
    the body and makes the launches of one train step on the counters (the
    CPU wrappers launch no kernel); a replay returns the captured outputs."""

    STEP = {(gather_conv.gather_conv, "launches"): 34,
            (gather_conv.gather_conv, "stem_launches"): 2,
            (conv_bwd.subm_conv_bwd, "launches"): 16,
            (conv_bwd.conv_dw, "launches"): 10,
            (conv_bwd.conv_dw, "stem_launches"): 2,
            (conv_bwd.dw_lists, "launches"): 8,
            (conv_bwd.down_dx, "launches"): 8,
            (masked_bn, "launches"): 26,
            (masked_bn, "bwd_launches"): 26}

    def capture(self, fn):
        self.outputs = fn()
        for (f, attr), n in self.STEP.items():
            setattr(f, attr, getattr(f, attr) + n)

    def replay(self):
        return self.outputs


def _solver(tmp_path, name="run", **kw):
    return S.Solver(_model(**kw), MEAN_SIZE, TEST_SPEC, "cpu", output_dir=str(tmp_path),
                    stamp=name)


def test_graph_keys_replays_and_a_load_that_drops_them(tmp_path):
    solver = _solver(tmp_path)
    assert solver.graphs is None  # the CPU steps eagerly
    graphs = solver.graphs = G.StepGraphs(solver.model, solver.optimizer, solver.mean_size,
                                          new_graph=EagerGraph)
    batches = {24: [_batch(0), _batch(1)], 16: [_batch(2, 16), _batch(3, 16)]}
    for grid in (24, 16):
        for i, batch in enumerate(batches[grid]):
            dd = graphs.load(stage(batch, TEST_SPEC), TEST_SPEC, "train")
            metrics, out = graphs.train_step(dd)
            assert torch.isfinite(metrics["loss"]) and out["ref_iou"].shape == (2,)
            step = graphs.graphs[("train", grid, "torch.float32")]
            # the first batch of a key is the eager warm-up; the second replays
            # from the static inputs that load wrote it into
            assert step.graph.replays == i and (dd is step.inputs)
            assert torch.equal(step.inputs["lang_feat"], torch.from_numpy(batch["lang_feat"]))
    own = batch_to_torch(_batch(4), TEST_SPEC, "cpu")
    kept = own["lang_feat"].clone()
    graphs.eval_step(own)
    graphs.eval_step(batch_to_torch(_batch(5), TEST_SPEC, "cpu"))
    assert torch.equal(own["lang_feat"], kept)  # copied, never written
    set_compute_dtype("bfloat16")
    try:
        graphs.eval_step(own)
    finally:
        set_compute_dtype(None)
    assert sorted(graphs.graphs) == [("eval", 24, "torch.bfloat16"), ("eval", 24, "torch.float32"),
                                     ("train", 16, "torch.float32"), ("train", 24, "torch.float32")]
    assert graphs.captures == 4
    with pytest.raises(ValueError, match="lang_feat"):
        bad = batch_to_torch(_batch(6), TEST_SPEC, "cpu")
        bad["lang_feat"] = bad["lang_feat"].double()
        graphs.eval_step(bad)

    path = solver.save_checkpoint("checkpoint", with_opt=True)
    solver.load_checkpoint(path, with_opt=True)
    assert graphs.graphs == {}
    graphs.train_step(graphs.load(stage(_batch(7), TEST_SPEC), TEST_SPEC, "train"))
    assert list(graphs.graphs) == [("train", 24, "torch.float32")] and graphs.captures == 5


def test_graph_steps_equal_eager_steps_through_a_fake_capture(tmp_path):
    """Two steps through the graph path (eager warm-up, then a replay of
    the captured body) equal two eager ``train_step``s."""
    models = [_model(1, dropout_override=0.0) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    opts = [S.make_optimizer(m.parameters(), 1e-3, 1e-5) for m in models]
    graphs = G.StepGraphs(models[1], opts[1], ms, new_graph=EagerGraph)
    for seed in (0, 1):
        dd = batch_to_torch(_batch(seed), TEST_SPEC, "cpu")
        want, _ = S.train_step(models[0], opts[0], dd, ms, bn_momentum=0.3)
        got, _ = graphs.train_step(dd, bn_momentum=0.3)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-6)
    for (n, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6, msg=n)


def test_launch_counts_read_as_eager_under_replay():
    model = _model()
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    graphs = G.StepGraphs(model, S.make_optimizer(model.parameters(), 1e-3, 1e-5), ms,
                          new_graph=CountingGraph)
    before = G.launch_counts()
    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    graphs.train_step(dd)  # warm-up (no launch on the CPU) and capture
    assert G.launch_counts() == before  # the capture's count is taken back
    for _ in range(3):
        graphs.train_step(dd)
    assert [a - b for a, b in zip(G.launch_counts(), before)] == [3 * 34, 3 * 2, 3 * 16, 3 * 10,
                                                                   3 * 2, 3 * 8, 3 * 8, 3 * 26,
                                                                   3 * 26, 0]


def _tensor_lr_adam(params, lr, wd):
    """The card's Adam (``make_optimizer`` on CUDA parameters) as far as the
    CPU takes it: a tensor lr, the float ``initial_lr``; not capturable,
    which the CPU does not support."""
    opt = torch.optim.Adam(list(params), lr=torch.tensor(lr), weight_decay=wd)
    for group in opt.param_groups:
        group["initial_lr"] = lr
    return opt


def _f32_schedule(lr, rate, epochs):
    """A float32 lr multiplied by ``rate`` in float32 after each epoch, as
    a tensor lr under MultiStepLR with a milestone at every epoch (and the
    JAX package's optax schedule) computes it."""
    out = [np.float32(lr)]
    for _ in range(epochs - 1):
        out.append(out[-1] * np.float32(rate))
    return out


def test_tensor_lr_follows_the_float_lr_over_epochs():
    """``make_scheduler``'s MultiStepLR writes a tensor lr in place; Adam
    with it moves the parameters as with the float lr, and a schedule
    rebuilt from a later epoch sets the same lr."""
    torch.manual_seed(3)
    init = torch.randn(5, 4)
    grads = torch.randn(3, 4, 5, 4)  # epochs x steps
    params = [torch.nn.Parameter(init.clone()) for _ in range(2)]
    opts = [S.make_optimizer([params[0]], 1e-2, 1e-3), _tensor_lr_adam([params[1]], 1e-2, 1e-3)]
    lr_tensor = opts[1].param_groups[0]["lr"]
    assert isinstance(lr_tensor, torch.Tensor) and isinstance(opts[0].param_groups[0]["lr"], float)
    scheds = [S.make_scheduler(o, [1, 2], 0.1) for o in opts]
    for epoch in range(3):
        for g in grads[epoch]:
            for p, o in zip(params, opts):
                p.grad = g.clone()
                o.step()
        torch.testing.assert_close(params[1], params[0], rtol=1e-6, atol=1e-7)
        assert float(lr_tensor) == pytest.approx(opts[0].param_groups[0]["lr"], rel=1e-6)
        assert float(lr_tensor) == pytest.approx(1e-2 * 0.1 ** epoch, rel=1e-6)
        assert float(lr_tensor) == float(_f32_schedule(1e-2, 0.1, epoch + 1)[epoch])
        for s in scheds:
            s.step()
    assert opts[1].param_groups[0]["lr"] is lr_tensor  # written in place
    S.make_scheduler(opts[1], [1, 2], 0.1, start_epoch=1)
    assert float(lr_tensor) == pytest.approx(1e-3, rel=1e-6)
    assert opts[1].param_groups[0]["initial_lr"] == pytest.approx(1e-2)


def test_checkpoints_carry_the_lr_between_its_kinds(tmp_path):
    """A solver whose Adam holds a tensor lr (as on a card) saves floats, in
    the reference's layout; a float-lr solver loads them, and back."""
    a = _solver(tmp_path, "a")
    a.optimizer = _tensor_lr_adam(a.model.parameters(), 1e-3, 1e-5)
    a.model.train()
    dd = batch_to_torch(_batch(), TEST_SPEC, "cpu")
    S.train_step(a.model, a.optimizer, dd, a.mean_size)
    a.optimizer.param_groups[0]["lr"].fill_(2e-4)
    path = a.save_checkpoint("checkpoint", with_opt=True)
    saved = torch.load(path, weights_only=True)["optimizer_state_dict"]
    assert saved["param_groups"][0]["lr"] == pytest.approx(2e-4)
    assert not any(isinstance(v, torch.Tensor) for v in saved["param_groups"][0].values())
    b = _solver(tmp_path, "b")
    b.load_checkpoint(path, with_opt=True)
    assert b.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)
    state_a = list(a.optimizer.state.values())
    state_b = list(b.optimizer.state.values())
    for sa, sb in zip(state_a, state_b):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sb[k], sa[k])
    c = _solver(tmp_path, "c")
    c.optimizer = _tensor_lr_adam(c.model.parameters(), 1e-3, 1e-5)
    c.load_checkpoint(b.save_checkpoint("checkpoint", with_opt=True), with_opt=True)
    lr = c.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and float(lr) == pytest.approx(2e-4)


def test_the_logged_lr_is_the_one_adam_applies(tmp_path):
    """``scalars.jsonl`` logs the lr in Adam's param group: with a tensor
    lr (as on a card), the float32 value each step applied, equal to the
    float32 schedule; a value written anywhere else would not show."""
    solver = S.Solver(_model(), MEAN_SIZE, TEST_SPEC, "cpu", output_dir=str(tmp_path),
                      stamp="lr", lr_decay_step=[1], lr_decay_rate=0.1)
    solver.optimizer = _tensor_lr_adam(solver.model.parameters(), 1e-3, 1e-5)
    applied = []
    solver.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: applied.append(float(opt.param_groups[0]["lr"])))
    solver({"train": [_batch(0), _batch(1)], "val": [_batch(2)]}, epoch=2, verbose=1)
    with open(os.path.join(solver.root, "scalars.jsonl")) as f:
        logged = [r["lr"] for r in map(json.loads, f) if r["phase"] == "train"]
    want = [float(x) for x in _f32_schedule(1e-3, 0.1, 2) for _ in range(2)]
    assert logged == applied == want and want[2] != 1e-4


def test_solver_epoch_through_graphs(tmp_path, monkeypatch):
    """The solver's loop on the graph path (``EagerGraph`` in place of the
    card's graphs): host batches go to the step unconverted and are written
    into a graph's inputs there, one capture per key, and the iter report
    gives each step's forward, backward and eval as its graph's marks
    measured them: an eval slowed by 30 ms reads at least that, and the
    report says where its times come from."""
    solver = _solver(tmp_path)
    solver.graphs = G.StepGraphs(solver.model, solver.optimizer, solver.mean_size,
                                 new_graph=EagerGraph)
    real_eval = G.get_eval

    def slow_eval(out):
        time.sleep(0.03)
        return real_eval(out)

    monkeypatch.setattr(G, "get_eval", slow_eval)
    loader = {"train": [_batch(0), _batch(1), _batch(2, 16)], "val": [_batch(3), _batch(4)]}
    solver(loader, epoch=1, verbose=1)
    assert solver.steps == {"train": 3, "val": 2}
    assert sorted(solver.graphs.graphs) == [("eval", 24, "torch.float32"),
                                            ("train", 16, "torch.float32"),
                                            ("train", 24, "torch.float32")]
    assert solver.graphs.graphs[("train", 24, "torch.float32")].graph.replays == 1
    assert (solver.graphs.replays, solver.graphs.steps) == (2, 5)
    text = open(os.path.join(solver.root, "log.txt")).read()
    forward = [float(x) for x in re.findall(r"mean_forward_time: (\S+)s", text)]
    backward = [float(x) for x in re.findall(r"mean_backward_time: (\S+)s", text)]
    evals = [float(x) for x in re.findall(r"mean_eval_time: (\S+)s", text)]
    iters = [float(x) for x in re.findall(r"mean_iter_time: (\S+)s", text)]
    assert len(forward) == len(backward) == len(evals) == 3
    assert all(f > 0 and b > 0 and 0.03 <= e for f, b, e in zip(forward, backward, evals))
    assert all(f + b + e <= t for f, b, e, t in zip(forward, backward, evals, iters))
    assert text.count("phase_times: the marks inside the step graphs") == 3


def test_solver_logs_its_step_path(tmp_path):
    solver = _solver(tmp_path)
    text = open(os.path.join(solver.root, "log.txt")).read()
    assert solver.graphs is None and "steps: eager (on cpu)" in text


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


@torch.no_grad()
def _copy_train_state(src_model, src_opt, dst_model, dst_opt):
    """``dst`` takes ``src``'s parameters, buffers and Adam state in place
    (the tensors a captured step reads)."""
    for d, s in zip(dst_model.state_dict().values(), src_model.state_dict().values()):
        d.copy_(s)
    for dp, sp in zip(dst_model.parameters(), src_model.parameters()):
        for k, v in src_opt.state[sp].items():
            dst_opt.state[dp][k].copy_(v)


@pytest.mark.gpu
def test_graph_replays_equal_eager_steps_on_card():
    """f32, TF32 off, dropout 0, two batches of one language grid with
    other description lengths (A, B): an eager step on A on both sides (the
    graph side's warm-up and capture on A), then the eager side's state
    copied into the graph's tensors, and replays of B and of A (new data in
    the captured inputs) against eager steps on the same batches, as
    ``chip_smoke.py`` holds the card against the CPU: the replay of B's
    loss to 1e-5, its gradients in L2 per layer (5e-2 of the layer's
    largest) and overall (2e-2), the running statistics to 1e-3; after the
    replay of A, each parameter within 2.5 x the summed lr + 1e-3 |p| (Adam
    moves an element whose gradient lies within rounding of 0 by +-lr either
    way; the BEV scatter sums with atomics, in no fixed order), all of them
    within 0.25 lr on average.  Then the eval graph captured on A, its
    replay on B against the eager eval step on B."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = [_model(2, dropout_override=0.0).to(dev) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    lr = 1e-3
    opts = [S.make_optimizer(m.parameters(), lr, 1e-5) for m in models]
    assert opts[1].param_groups[0]["capturable"]
    graphs = G.StepGraphs(models[1], opts[1], ms)
    host = [_batch(0), _batch(1)]
    assert not np.array_equal(host[0]["lang_len"], host[1]["lang_len"])
    d_a, d_b = (batch_to_torch(b, TEST_SPEC, dev) for b in host)
    S.train_step(models[0], opts[0], d_a, ms)
    graphs.train_step(d_a)
    _copy_train_state(models[0], opts[0], models[1], opts[1])
    counts = G.launch_counts()
    want, _ = S.train_step(models[0], opts[0], d_b, ms)
    got, _ = graphs.train_step(d_b)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    layer_max, num, den = {}, 0.0, 0.0
    grads = {n: (p.grad, q.grad) for (n, p), q in zip(models[0].named_parameters(),
                                                      models[1].parameters())}
    for n, (e, _) in grads.items():
        layer = n.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), e.norm().item())
    for n, (e, g) in grads.items():
        d = (g - e).norm().item()
        assert d <= 5e-2 * max(layer_max[n.rsplit(".", 1)[0]], 1e-30), n
        num, den = num + d * d, den + e.norm().item() ** 2
    assert (num / den) ** 0.5 <= 2e-2
    for (n, e), g in zip(models[0].named_buffers(), models[1].buffers()):
        if "running" in n:
            torch.testing.assert_close(g, e, rtol=1e-3, atol=1e-5, msg=n)
    S.train_step(models[0], opts[0], d_a, ms)
    graphs.train_step(d_a)
    assert graphs.captures == 1
    launched = [a - b for a, b in zip(G.launch_counts(), counts)]
    # 4 steps (2 eager, 2 replays); f32 takes no stem kernel, no list pass and
    # no dX over the lists; the fused masked BN at the encoders' 26 BNs; no
    # inverse conv
    assert launched == [4 * 34, 0, 4 * 16, 4 * 10, 0, 0, 0, 4 * 26, 4 * 26, 0]
    total, count = 0.0, 0
    for e, g in zip(models[0].parameters(), models[1].parameters()):
        diff = (g - e).abs()
        assert bool((diff <= 2.5 * 2 * lr + 1e-3 * e.abs()).all())
        total, count = total + diff.sum().item(), count + diff.numel()
    assert total <= 0.25 * lr * count
    graphs.eval_step(d_a)  # the warm-up, then the capture on A
    want = G.eval_body(models[1], d_b, ms)[1]
    _, got = graphs.eval_step(d_b)
    assert graphs.captures == 2
    for k in ("loss", "lang_scores", "attribute_scores", "relation_scores", "scene_scores"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.gpu
def test_a_new_language_grid_captures_its_own_graph_on_card():
    dev = _card()
    model = _model(3).to(dev)
    ms = torch.tensor(MEAN_SIZE, dtype=torch.float32, device=dev)
    graphs = G.StepGraphs(model, S.make_optimizer(model.parameters(), 1e-3, 1e-5), ms)
    for grid in (24, 16, 24, 16):
        staged = stage_to(_batch(grid, grid), TEST_SPEC, dev)
        metrics, out = graphs.train_step(graphs.load(staged, TEST_SPEC, "train"))
        assert torch.isfinite(metrics["loss"]) and bool(((out["ref_iou"] >= 0) &
                                                         (out["ref_iou"] <= 1)).all())
    assert graphs.captures == 2 and len(graphs.graphs) == 2
