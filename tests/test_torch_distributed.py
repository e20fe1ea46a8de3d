"""The port's data parallelism (``instancerefer_tpu_torch/parallel``) on the
CPU: two gloo ranks in subprocesses that import no jax
(``tests/torch_ddp_rank.py``), meeting through a ``file://`` store.

* One train step of the ``Solver``'s DDP model, each rank on its
  ``PaddedLoader`` shard of a 4-sample global batch, and of a partial
  3-sample one (rank 1 then holds 1 valid sample of 2), dropout 0, f32:
  - against a single-process port step on the global batch in the order
    the ranks hold it (rank 0's samples, then rank 1's: 0, 2, 1, 3, the
    assembly order of ``__graft_entry__.dryrun_multihost``): the loss and
    every running statistic to 1e-5 relative (of the buffer's largest
    value), the gradients in L2, all of them together to 1e-4 and each
    layer's to 2e-3 of its norm.  Per layer 1e-5 is below the f32 noise of
    this step: its BatchNorms see 3 or 4 rows, and their backward projects
    a layer's gradient onto n - 2 dimensions, so it cancels.  On the
    single-process step, a 1e-7 relative perturbation of the weights moved
    the gradient of ``relation.lang_emb_fc.0.weight`` by 4.3e-4 of its norm
    in the partial case, and putting the samples in another order moved
    layers by up to 3.4e-5.  A wrong denominator or a missing all-reduce
    moves a layer by tens of percent.
  - against the JAX package's single-process train step on the same global
    batch (the port's, in raster row order; without band metadata the JAX
    model takes its gather path), with the tolerances of
    ``tests/test_torch_train.py``.
  - the two ranks' gradients and parameters after Adam are bit-identical.
* ``MaskedBatchNorm`` over 2 ranks equals one BN over the union of their
  rows, forward (outputs, running statistics) and backward (dX, and the
  ranks' dW and dB summed), with and without a row mask.
* ``host_shard_indices`` equals the JAX package's.
* At world size 1 a train step makes no collective call and is bit for bit
  the step without a process group.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instancerefer_tpu.data import pipeline as jpipeline
from instancerefer_tpu.data import synthetic as jsynthetic
from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.parallel import mesh

from instancerefer_tpu_torch.data import pipeline
from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.parallel import distributed
from instancerefer_tpu_torch.train import solver

import torch_ddp_rank as R
from jax_weights import state_dict_from_jax
from test_torch_host_pipeline import assert_same_batch, jax_spec
from test_torch_train import _check_gradients, _np_tree, jax_train  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SPEC = R.SPEC  # the port's TEST_SPEC
JSPEC = jsynthetic.TEST_SPEC  # the JAX package's, without bands
ORDER = [0, 2, 1, 3]  # rank 0's positions, then rank 1's
LOSS_RTOL, STATS_RTOL, GRAD_ALL, GRAD_LAYER = 1e-5, 1e-5, 1e-4, 2e-3


def spawn_ranks(workdir):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_ddp_rank.py"),
                               str(r), str(WORLD), str(workdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {case: [torch.load(os.path.join(workdir, f"{case}_rank{r}.pt"), weights_only=False)
                   for r in range(WORLD)]
            for case in ("bn", *R.CASES)}


def _global_batch(n):
    """The port's global batch of ``n`` samples in the ranks' order; equal bit
    for bit to the JAX package's raster-order batch."""
    cores = R.cores(n)
    batch = pipeline.finalize_batch([pipeline.pad_sample(cores[i], SPEC) for i in ORDER[:n]],
                                    R.GLOBAL_BATCH, SPEC)
    rng = np.random.default_rng(5)
    jcores = [jsynthetic.make_core_sample(rng, num_instances=6, num_candidates=3, scan_idx=i,
                                          mean_size_arr=R.MEAN_SIZE) for i in range(n)]
    jspec = jax_spec(SPEC)
    assert_same_batch(batch, jpipeline.finalize_batch(
        [jpipeline.pad_sample(jcores[i], jspec) for i in ORDER[:n]], R.GLOBAL_BATCH, jspec))
    return batch


@pytest.fixture(scope="module")
def runs(jax_train, tmp_path_factory):
    """{case: (the two ranks' results, the single-process port step, the
    JAX step)} from the JAX model's initial weights."""
    workdir = tmp_path_factory.mktemp("ddp")
    j = jax_train
    sd0 = state_dict_from_jax(j["params"], j["stats"])
    torch.save(sd0, workdir / "init.pt")
    ranks = spawn_ranks(workdir)
    out = {"bn": ranks["bn"]}
    for case, n in R.CASES.items():
        batch = _global_batch(n)
        model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                              dropout_override=0.0)
        model.load_state_dict(sd0)
        opt = solver.make_optimizer(model.parameters(), 1e-3, 1e-5)
        metrics, _ = solver.train_step(model, opt, batch_to_torch(batch, SPEC, "cpu"),
                                       torch.tensor(R.MEAN_SIZE, dtype=torch.float32))
        single = {"loss": float(metrics["loss"]),
                  "grads": {k: p.grad for k, p in model.named_parameters()},
                  "stats": {k: b for k, b in model.named_buffers() if "running" in k}}
        loss, grads, _, stats, _ = j["step"](j["params"], j["stats"], j["tx"].init(j["params"]),
                                             batch_to_device_dict(batch, JSPEC), 0.1)
        want = state_dict_from_jax(_np_tree(grads), _np_tree(stats))
        jx = {"loss": float(loss), "grads": want,
              "stats": state_dict_from_jax(j["params"], _np_tree(stats))}
        out[case] = (ranks[case], single, jx)
    return out


def _layer_norms(grads):
    norms = {}
    for name, g in grads.items():
        layer = name.rsplit(".", 1)[0]
        norms[layer] = max(norms.get(layer, 0.0), float(g.norm()))
    return norms


@pytest.mark.parametrize("case", sorted(R.CASES))
def test_two_ranks_match_the_single_process_step(runs, case):
    ranks, single, _ = runs[case]
    assert all(r["wrapped"] for r in ranks)  # the Solver wrapped the model in DDP
    valid = [int(r["sample_valid"].sum()) for r in ranks]
    assert valid == ([2, 2] if case == "full" else [2, 1])
    for r in ranks:
        assert abs(r["loss"] - single["loss"]) <= LOSS_RTOL * abs(single["loss"])
        assert r["metrics"]["iou_count"] == R.CASES[case]  # the global valid count
    got, want = ranks[0]["grads"], single["grads"]
    assert set(got) == set(want) and len(got) == 167
    norms = _layer_norms(want)
    num = den = 0.0
    for name, w in want.items():
        err = float((got[name] - w).norm())
        layer = norms[name.rsplit(".", 1)[0]]
        assert err <= GRAD_LAYER * layer, f"{name}: L2 error {err / layer:.2e} of its layer"
        num, den = num + err ** 2, den + float(w.norm()) ** 2
    assert (num / den) ** 0.5 <= GRAD_ALL
    for name, w in single["stats"].items():
        err = float((ranks[0]["stats"][name] - w).abs().max())
        assert err <= STATS_RTOL * float(w.abs().max()), name
    for key in ("grads", "params", "stats"):  # DDP keeps the replicas equal
        for name, t in ranks[0][key].items():
            assert torch.equal(t, ranks[1][key][name]), (key, name)


@pytest.mark.parametrize("case", sorted(R.CASES))
def test_two_ranks_match_the_jax_global_batch_step(runs, case):
    ranks, _, jx = runs[case]
    np.testing.assert_allclose(ranks[0]["loss"], jx["loss"], rtol=1e-4)
    _check_gradients(ranks[0]["grads"], jx["grads"], 2e-3)
    for name, t in ranks[0]["stats"].items():
        w = jx["stats"][name].numpy()
        np.testing.assert_allclose(t.numpy(), w, rtol=5e-3, atol=5e-3 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("name", ["masked", "all", "fused"])
def test_batchnorm_over_two_ranks_equals_one_over_the_union(runs, name):
    """``fused``: the encoders' fused path (mask, ReLU, residual) on each
    rank against the unfused BN, add and ReLU over the union."""
    rows = [R.bn_rows(r) for r in range(WORLD)]
    x = torch.from_numpy(np.concatenate([a[0] for a in rows])).requires_grad_(True)
    mask = torch.from_numpy(np.concatenate([a[1] for a in rows])) if name != "all" else None
    g = torch.from_numpy(np.concatenate([a[2] for a in rows]))
    res = torch.from_numpy(np.concatenate([a[3] for a in rows])).requires_grad_(True)
    bn = MaskedBatchNorm(R.BN_C).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    y = bn(x, mask)
    if name == "fused":
        y = torch.relu(y + res)
    (y * g).sum().backward()
    got = [r[name] for r in runs["bn"]]
    want_grads = [("y", y.detach()), ("dx", x.grad)]
    if name == "fused":
        want_grads.append(("dres", res.grad))
    for key, want in want_grads:
        np.testing.assert_allclose(torch.cat([r[key] for r in got]).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key, want in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
        np.testing.assert_allclose((got[0][key] + got[1][key]).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key])
        np.testing.assert_allclose(got[0][key].numpy(), getattr(bn, key).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("n,count", [(0, 2), (7, 2), (8, 2), (9, 3), (32, 4)])
def test_host_shard_indices_equal_jax(n, count):
    for index in range(count):
        np.testing.assert_array_equal(
            distributed.host_shard_indices(n, index, count),
            mesh.host_shard_indices(n, process_index=index, process_count=count))


def test_world_size_one_adds_no_collective(tmp_path, monkeypatch):
    batch = _global_batch(3)
    steps = {}
    calls = []
    for name in ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "barrier"):
        real = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _real=real, _name=name, **k: (
            calls.append(_name), _real(*a, **k))[1])
    for mode in ("no group", "world 1"):
        if mode == "world 1":
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            distributed.init_from_env("cpu", init_method=f"file://{tmp_path}/store")
        try:
            assert distributed.world_size() == 1 and distributed.active() == (mode == "world 1")
            model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                                  generator=torch.Generator().manual_seed(0),
                                  dropout_override=0.0)
            run = solver.Solver(model, R.MEAN_SIZE, SPEC, "cpu",
                                output_dir=str(tmp_path / mode.replace(" ", "_")))
            assert run.train_model is run.model  # no DDP wrapper
            metrics, _ = solver.train_step(run.train_model, run.optimizer,
                                           batch_to_torch(batch, SPEC, "cpu"), run.mean_size)
            steps[mode] = (metrics, {k: p.grad for k, p in model.named_parameters()})
        finally:
            distributed.shutdown()
    assert calls == []
    (m0, g0), (m1, g1) = steps["no group"], steps["world 1"]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
