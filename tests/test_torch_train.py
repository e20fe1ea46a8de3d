"""The port's train step (``instancerefer_tpu_torch/train/solver.train_step``)
against the JAX package's, on the same numpy batch and the same weights.

The batch is ``finalize_batch`` of 3 synthetic samples padded to 4, so every
``sample_valid`` mask is live.  Dropout is 0 on both sides
(``dropout_override=0.0``): flax and torch draw from different streams.

* Step 0: the loss and every parameter gradient against
  ``jax.value_and_grad`` of the JAX model in train mode, with the names of
  ``state_dict_from_jax(grads, stats)``.  Tolerance as
  ``tests/test_golden_grads.py``: rtol 2e-3, atol max(2e-3 * max|g|, 1e-6),
  with max|g| taken over the parameter's layer: in train mode the bias of a
  layer that feeds a BatchNorm has an analytically zero gradient, so both
  sides hold rounding noise there, on the scale of the layer's weight
  gradient.  The gradients of the later steps (from JAX's state, below)
  take 5e-3 of the layer's largest gradient: up to 2e-3 of it was measured
  on the language path at step 1 of this batch.
* A 3-step trajectory through Adam with weight decay, an LR milestone after
  step 0 and a BN-momentum change at step 2, against the JAX package's
  ``make_optimizer`` and ``bn_momentum_for_epoch``: parameters and running
  statistics after each step, by the two-tier rule of
  ``tests/test_golden_trajectory.py`` (Adam moves near-zero-gradient
  elements by +-lr with a sign set by rounding, on both sides).  Those
  moves change later gradients, so the trajectory is held two ways: each
  step started from JAX's state (parameters, statistics, Adam moments) must
  land on JAX's next state tightly, and the port's free-running trajectory
  must stay within the random-walk envelope.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instancerefer_tpu.data import pipeline, synthetic
from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.data.synthetic import TEST_SPEC
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.train import solver as jax_solver
from instancerefer_tpu.train.losses import get_loss as jax_loss

from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.ops import conv_bwd, gather_conv
from instancerefer_tpu_torch.train import solver
from instancerefer_tpu_torch.train.losses import get_loss

from jax_weights import state_dict_from_jax
from test_torch_slice import rules_batch

SPEC = TEST_SPEC
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
B, VALID = 4, 3
N_STEPS = 3
# wd well above the reference's 1e-5 so that the fold of L2 into the
# gradient shows at trajectory tolerances
LR, WD = 1e-3, 1e-2
MILESTONES, GAMMA = [1], 0.1
BN_STEP, BN_RATE = 2, 0.5
LR_CUM = np.cumsum([LR * GAMMA ** sum(m <= k for m in MILESTONES) for k in range(N_STEPS)])


def partial_batch():
    rng = np.random.default_rng(5)
    samples = [
        pipeline.pad_sample(synthetic.make_core_sample(
            rng, num_instances=6, num_candidates=3, scan_idx=i, mean_size_arr=MEAN_SIZE,
        ), SPEC)
        for i in range(VALID)
    ]
    return pipeline.finalize_batch(samples, B, SPEC)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _adam_moments(opt_state, stats):
    adam = next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))
    return (state_dict_from_jax(_np_tree(adam.mu), stats),
            state_dict_from_jax(_np_tree(adam.nu), stats))


@pytest.fixture(scope="module")
def jax_train():
    """The JAX model's initial state and its jitted train step (one compile
    serves every batch of the same structure)."""
    jdd = batch_to_device_dict(partial_batch(), SPEC)
    model = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                     max_candidates=SPEC.max_candidates, dropout_override=0.0)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jdd)
    tx = jax_solver.make_optimizer(LR, WD, MILESTONES, GAMMA, steps_per_epoch=1)
    ms = jnp.asarray(MEAN_SIZE, jnp.float32)

    @jax.jit
    def step(params, stats, opt_state, dd, momentum):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, dd, train=True,
                                   bn_momentum=momentum, rngs={"dropout": jax.random.key(0)},
                                   mutable=["batch_stats"])
            return jax_loss(out, ms)["loss"], upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), stats, opt_state

    return dict(params=_np_tree(v["params"]), stats=_np_tree(v["batch_stats"]), tx=tx, step=step)


def _port_model(sd):
    port = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                         dropout_override=0.0)
    port.load_state_dict(sd)
    return port


@pytest.fixture(scope="module")
def runs(jax_train):
    """JAX's steps, the port's free-running steps, and the port's steps
    each started from JAX's state after the step before (Adam moments
    included)."""
    batch = partial_batch()
    jdd = batch_to_device_dict(batch, SPEC)
    params, stats, tx, step = (jax_train[k] for k in ("params", "stats", "tx", "step"))
    sd0 = state_dict_from_jax(params, stats)
    want = []
    opt_state = tx.init(params)
    for k in range(N_STEPS):
        m = jax_solver.bn_momentum_for_epoch(k, BN_STEP, BN_RATE)
        loss, grads, params, stats, opt_state = step(params, stats, opt_state, jdd, m)
        params, stats = _np_tree(params), _np_tree(stats)
        want.append(dict(loss=float(loss), grads=state_dict_from_jax(_np_tree(grads), stats),
                         state=state_dict_from_jax(params, stats),
                         moments=_adam_moments(opt_state, stats)))

    tdd = batch_to_torch(batch, SPEC, "cpu")
    tms = torch.tensor(MEAN_SIZE, dtype=torch.float32)
    launches = (gather_conv.gather_conv.launches, conv_bwd.subm_conv_bwd.launches,
                conv_bwd.conv_dw.launches)
    got = {}
    for mode in ("free", "forced"):
        port = _port_model(sd0)
        opt = solver.make_optimizer(port.parameters(), LR, WD)
        sched = solver.make_scheduler(opt, MILESTONES, GAMMA)
        got[mode] = []
        for k in range(N_STEPS):
            if mode == "forced" and k > 0:
                port.load_state_dict(want[k - 1]["state"])
                mu, nu = want[k - 1]["moments"]
                for name, p in port.named_parameters():
                    opt.state[p] = {"step": torch.tensor(float(k)), "exp_avg": mu[name].clone(),
                                    "exp_avg_sq": nu[name].clone()}
            metrics, out = solver.train_step(
                port, opt, tdd, tms, solver.bn_momentum_for_epoch(k, BN_STEP, BN_RATE))
            got[mode].append(dict(
                loss=float(metrics["loss"]), metrics=metrics, out=out,
                grads={n: p.grad.clone() for n, p in port.named_parameters()},
                state={n: t.clone() for n, t in port.state_dict().items()},
            ))
            sched.step()
    assert launches == (gather_conv.gather_conv.launches, conv_bwd.subm_conv_bwd.launches,
                        conv_bwd.conv_dw.launches)  # CPU tensors run the twins
    return want, got


def test_loss_matches(runs):
    want, got = runs
    losses = [w["loss"] for w in want]
    np.testing.assert_allclose([g["loss"] for g in got["forced"]], losses, rtol=1e-4)
    np.testing.assert_allclose([g["loss"] for g in got["free"]], losses, rtol=2e-3, atol=2e-3)
    assert got["free"][0]["loss"] == got["forced"][0]["loss"]
    assert abs(losses[-1] - losses[0]) > 1e-3  # the trajectory moves


def _check_gradients(tg, wg, share):
    assert set(tg) <= set(wg) and len(tg) == 167
    layer_scale = {}
    for name in tg:
        layer = name.rsplit(".", 1)[0]
        layer_scale[layer] = max(layer_scale.get(layer, 0.0), float(wg[name].abs().max()))
    for name in sorted(tg):
        g, w = tg[name].numpy(), wg[name].numpy()
        scale = max(layer_scale[name.rsplit(".", 1)[0]], 1e-6)
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=max(share * scale, 1e-6),
                                   err_msg=f"{name} (layer |g|max={scale:.2e})")


@pytest.mark.parametrize("step", range(N_STEPS))
def test_every_parameter_gradient_matches(runs, step):
    want, got = runs
    _check_gradients(got["forced"][step]["grads"], want[step]["grads"],
                     2e-3 if step == 0 else 5e-3)


def test_gradients_through_the_loss_skip_rules(jax_train):
    """The batch of ``test_torch_slice``: 3 candidates, 1 (selected, not
    scored), 0 (a miss) and 4 whose best IoU is below 0.2 (the ref loss
    skips it) — where a silently blocked or leaking gradient would hide."""
    batch = rules_batch()
    batch["sample_valid"] = np.ones(B, bool)  # the structure the step was compiled for
    j = jax_train
    loss, grads, _, stats, _ = j["step"](j["params"], j["stats"], j["tx"].init(j["params"]),
                                         batch_to_device_dict(batch, SPEC), 0.1)
    port = _port_model(state_dict_from_jax(j["params"], j["stats"])).train()
    out = get_loss(port(batch_to_torch(batch, SPEC, "cpu")),
                   torch.tensor(MEAN_SIZE, dtype=torch.float32))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].detach().item(), float(loss), rtol=1e-4)
    _check_gradients({n: p.grad for n, p in port.named_parameters()},
                     state_dict_from_jax(_np_tree(grads), _np_tree(stats)), 2e-3)


def test_gradients_reach_every_module_and_sparse_conv(runs):
    _, got = runs
    grads = got["forced"][0]["grads"]
    for mod in ("lang", "attribute", "relation", "scene"):
        assert sum(float(g.abs().sum()) for n, g in grads.items() if n.startswith(mod)) > 0, mod
    kernels = [n for n in grads if n.endswith(".kernel")]
    assert len(kernels) == 2 * 13 + 1  # 2 encoders x 13 sparse convs, and the BEV kernel
    for n in kernels:
        assert grads[n].abs().max() > 0, n


def _two_tier(a, b, step, name, tight_frac=0.998):
    """Every element within the cumulative-lr random walk of Adam's
    near-zero-gradient directions, and ``tight_frac`` of them tight."""
    diff = np.abs(a - b)
    loose = 2.5 * LR_CUM[step] + 5e-3 * np.abs(b)
    assert not (diff > loose).any(), (
        f"step {step} {name}: max diff {diff.max():.2e} beyond the lr random walk")
    scale = max(float(np.abs(b).max()), 1e-3)
    tight = diff <= 5e-3 * np.abs(b) + max(5e-3 * scale, 2e-5 * (step + 1))
    assert float(tight.mean()) >= tight_frac, (
        f"step {step} {name}: {tight.mean():.4f} of elements tight, max diff {diff.max():.2e}")


@pytest.mark.parametrize("kind", ["parameters", "running_stats"])
def test_each_step_from_jax_state_matches(runs, kind):
    """Each step, started from JAX's state after the step before, lands on
    JAX's state after it: the LR milestone, the weight-decay fold, Adam's
    moments and the BN-momentum change, one step at a time.  Leaves whose
    gradient is rounding noise (max < 1e-4: biases feeding a BatchNorm,
    attention-logit biases) take the random-walk bound only."""
    want, got = runs
    for k in range(N_STEPS):
        g = got["forced"][k]["grads"]
        for name, t in got["forced"][k]["state"].items():
            if name.endswith("num_batches_tracked"):
                continue  # torch's own BN counter; JAX keeps none
            if (name in g) != (kind == "parameters"):
                continue
            gauge = name in g and float(g[name].abs().max()) < 1e-4
            _two_tier(t.numpy(), want[k]["state"][name].numpy(), 0, name,
                      tight_frac=0.0 if gauge else 0.998)


def test_free_running_parameters_stay_in_the_random_walk(runs):
    """The port's own 3-step trajectory: every parameter within the
    cumulative-lr envelope of JAX's at every step, and torch's BN counter
    counts the steps."""
    want, got = runs
    for k, step in enumerate(got["free"]):
        for name, t in step["state"].items():
            if name.endswith("num_batches_tracked"):
                assert int(t) == k + 1
            elif name in step["grads"]:
                _two_tier(t.numpy(), want[k]["state"][name].numpy(), k, name, tight_frac=0.0)


def test_train_step_metrics(runs):
    _, got = runs
    for step in got["free"]:
        m = step["metrics"]
        assert int(m["iou_count"]) == VALID
        assert all(bool(torch.isfinite(v)) for v in m.values())
        assert 0 <= int(m["iou5_hits"]) <= int(m["iou25_hits"]) <= VALID
        iou = step["out"]["ref_iou"]
        assert iou.shape == (B,) and bool(((iou >= 0) & (iou <= 1)).all())


def test_lr_and_bn_momentum_schedules_match_jax():
    tx_lr = optax.piecewise_constant_schedule(LR, {e: GAMMA for e in (1, 3)})
    opt = solver.make_optimizer([torch.nn.Parameter(torch.zeros(1))], LR, 0.0)
    sched = solver.make_scheduler(opt, [1, 3], GAMMA)
    for epoch in range(5):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(tx_lr(epoch)), rtol=1e-6)
        opt.step()
        sched.step()
    for cfg in ((None, None), (2, 0.5), (10, 0.1)):
        for epoch in range(0, 40, 3):
            assert solver.bn_momentum_for_epoch(epoch, *cfg) == \
                jax_solver.bn_momentum_for_epoch(epoch, *cfg)


def test_dropout_rates_scale_and_eval_identity():
    model = InstanceRefer(7, 18, 4)
    ps = sorted(m.p for m in model.modules() if isinstance(m, torch.nn.Dropout))
    assert ps == [0.1] + [0.15] * 5  # lang word dropout; relation x2, scene x3
    over = InstanceRefer(7, 18, 4, dropout_override=0.5)
    drops = [m for m in over.modules() if isinstance(m, torch.nn.Dropout)]
    assert {m.p for m in drops} == {0.5}
    torch.manual_seed(0)
    x = torch.ones(20000)
    y = drops[0].train()(x)
    kept = y[y != 0]
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(kept, torch.full_like(kept, 2.0))  # 1 / (1 - p)
    assert torch.equal(drops[0].eval()(x), x)
