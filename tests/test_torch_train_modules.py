"""Each module of the port in train mode against its flax counterpart with
``train=True`` and ``mutable=["batch_stats"]``: the masked BatchNorm (row
masks, plane masks on NCHW, no mask, bf16 input), the two sparse encoders
(K1 forward, masked BN over each stage's valid rows), and the language,
attribute, relation and scene modules with dropout 0.  Outputs and the
updated running statistics are compared; weights come from the JAX init
through ``state_dict_from_jax``, running statistics start off their
defaults, and the batch has a loader-padded sample (``sample_valid``).

Tolerance: f32 on both sides, sums in other orders — 1e-5 for single ops,
1e-4 where an encoder stacks 13 convs and BatchNorms; a bf16 output may
differ by one bf16 ulp (1e-2 relative).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.models import attribute_module as jattr
from instancerefer_tpu.models import basic_blocks as jbb
from instancerefer_tpu.models import lang_module as jlang
from instancerefer_tpu.models import relation_module as jrel
from instancerefer_tpu.models import scene_module as jscene
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel

from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer

from jax_weights import state_dict_from_jax
from test_torch_train import B, SPEC, partial_batch

MOMENTUM = 0.3


def _bn_inputs(kind, rng, c=16):
    if kind == "planes":
        x = (rng.normal(size=(3, 4, 5, c)) * 2 + 1).astype(np.float32)
        mask = np.broadcast_to(np.array([True, False, True])[:, None, None], (3, 4, 5))
    else:
        x = (rng.normal(size=(40, c)) * 2 + 1).astype(np.float32)
        mask = None if kind == "none" else rng.uniform(size=40) < 0.6
    if kind == "rows_bf16":  # |mean| >> std: the case f32 statistics exist for
        x = np.array(jnp.asarray(x * 0.05 + 6.0).astype(jnp.bfloat16).astype(jnp.float32))
    return x, mask


@pytest.mark.parametrize("kind", ["rows", "planes", "none", "rows_bf16"])
def test_masked_batchnorm_train_matches_flax(kind):
    rng = np.random.default_rng(["rows", "planes", "none", "rows_bf16"].index(kind))
    x, mask = _bn_inputs(kind, rng)
    c = x.shape[-1]
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    mean, var = rng.normal(size=c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    bf16 = kind == "rows_bf16"
    jx = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    want, upd = jbb.MaskedBatchNorm(c).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        jx, None if mask is None else jnp.asarray(mask), train=True, momentum=MOMENTUM,
        mutable=["batch_stats"])

    bn = MaskedBatchNorm(c).train()
    bn.momentum = MOMENTUM
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    tmask = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask))
    if kind == "planes":  # the port's dense BN runs on NCHW
        got = bn(tx.permute(0, 3, 1, 2), tmask, channel_dim=1).permute(0, 2, 3, 1)
    else:
        got = bn(tx, tmask)
    assert got.dtype == tx.dtype
    tol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


@pytest.fixture(scope="module")
def setup():
    batch = partial_batch()
    jdd = batch_to_device_dict(batch, SPEC)
    model = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                     max_candidates=SPEC.max_candidates)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jdd)
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(0, 0.02, a.shape) if p[-1].key == "mean"
                      else np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        jax.device_get(v["batch_stats"]))
    port = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                         dropout_override=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    port.set_bn_momentum(MOMENTUM)
    return dict(jdd=jdd, tdd=batch_to_torch(batch, SPEC, "cpu"), params=params, stats=stats,
                port=port)


def _run_flax(s, path, fn):
    """flax ``fn(variables)`` in train mode on the variables at ``path`` ->
    (output, its port-named running statistics)."""
    p, st = s["params"], s["stats"]
    for k in path:
        p, st = p[k], st[k]
    out, upd = jax.jit(fn)({"params": p, "batch_stats": st})
    full = copy.deepcopy(s["stats"])
    node = full
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = jax.tree.map(np.asarray, upd["batch_stats"])
    sd = state_dict_from_jax(s["params"], full)
    prefix = ".".join(path) + "."
    return out, {k[len(prefix):]: v for k, v in sd.items()
                 if k.startswith(prefix) and "running" in k}


def _check_stats(port_module, want, tol):
    got = {k: v for k, v in port_module.state_dict().items() if "running" in k}
    assert set(got) == set(want) and got
    for k in sorted(got):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


def _np(t):
    return t.detach().numpy()


def _lang_feats(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(B, 256)).astype(np.float32)
            for k in ("lang_attr_feats", "lang_rel_feats", "lang_scene_feats")}


def _inputs(s, keys, seed, **extra):
    jin = {**{k: s["jdd"][k] for k in keys}, **_lang_feats(seed), **extra}
    tin = {**{k: s["tdd"][k] for k in keys},
           **{k: torch.from_numpy(v) for k, v in _lang_feats(seed).items()},
           **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jin, tin


@pytest.mark.parametrize("prefix,module", [("inst", "attribute"), ("scene", "scene")])
def test_encoder_train_matches_flax(setup, prefix, module):
    s = setup
    pyr = s["jdd"][f"{prefix}_pyramid"]
    want, stats = _run_flax(s, (module, "net"), lambda v: jbb.SparseConvEncoder().apply(
        v, s["jdd"][f"{prefix}_feats"], pyr, train=True, bn_momentum=MOMENTUM,
        mutable=["batch_stats"]))
    enc = copy.deepcopy(getattr(s["port"], module).net).train()
    got = _np(enc(s["tdd"][f"{prefix}_feats"], s["tdd"][f"{prefix}_pyramid"]))
    live = np.asarray(pyr[-1].mask)
    assert live.any() and np.abs(np.asarray(want)[live]).max() > 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    _check_stats(enc, stats, dict(rtol=1e-4, atol=1e-5))


def test_lang_module_train_matches_flax(setup):
    s = setup
    keys = ("lang_feat", "lang_len")
    want = jax.jit(lambda v, d: jlang.LangModule(
        num_text_classes=SPEC.num_classes, word_dropout=0.0).apply(
        v, d, train=True, rngs={"dropout": jax.random.key(0)}))(
        {"params": s["params"]["lang"]}, {k: s["jdd"][k] for k in keys})
    got = copy.deepcopy(s["port"].lang).train()({k: s["tdd"][k] for k in keys})
    for k in ("lang_scores", "lang_feat", "lang_attr_feats", "lang_rel_feats",
              "lang_scene_feats", "atten_scene"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_attribute_module_train_matches_flax(setup):
    s = setup
    jin, tin = _inputs(s, ("inst_pyramid", "inst_feats", "cand_mask", "sample_valid"), 1)
    mod = jattr.AttributeModule(input_feature_dim=SPEC.feat_dim,
                                max_candidates=SPEC.max_candidates)
    want, stats = _run_flax(s, ("attribute",), lambda v: mod.apply(
        v, jin, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"]))
    port = copy.deepcopy(s["port"].attribute).train()
    got = port(tin)
    m = np.asarray(want["score_mask"])
    assert m.any()
    np.testing.assert_allclose(_np(got["obj_feats"]), np.asarray(want["obj_feats"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got["attribute_scores"])[m],
                               np.asarray(want["attribute_scores"])[m], rtol=1e-4, atol=1e-5)
    _check_stats(port, stats, dict(rtol=1e-4, atol=1e-5))


def test_relation_module_train_matches_flax(setup):
    s = setup
    jin, tin = _inputs(s, ("instance_mask", "instance_class", "instance_obbs",
                           "instance_node_feat", "cand_slot", "cand_mask", "sample_valid"), 2)
    mod = jrel.RelationModule(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                              dropout_rate=0.0)
    want, stats = _run_flax(s, ("relation",), lambda v: mod.apply(
        v, jin, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"]))
    port = copy.deepcopy(s["port"].relation).train()
    got = _np(port(tin)["relation_scores"])
    m = np.asarray(s["jdd"]["cand_mask"])
    np.testing.assert_allclose(got[m], np.asarray(want["relation_scores"])[m], rtol=1e-5,
                               atol=1e-6)
    _check_stats(port, stats, dict(rtol=1e-5, atol=1e-6))


def test_scene_module_train_matches_flax(setup):
    s = setup
    obj = np.random.default_rng(3).normal(size=(B, SPEC.max_candidates, 128)).astype(np.float32)
    jin, tin = _inputs(s, ("scene_pyramid", "scene_feats", "cand_mask", "sample_valid"), 3,
                       obj_feats=obj)
    mod = jscene.SceneModule(input_feature_dim=SPEC.feat_dim, dropout_rate=0.0)
    want, stats = _run_flax(s, ("scene",), lambda v: mod.apply(
        v, jin, train=True, bn_momentum=MOMENTUM, mutable=["batch_stats"]))
    port = copy.deepcopy(s["port"].scene).train()
    got = port(tin)
    for k in ("seg_scores", "scene_scores", "vis_atten"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    _check_stats(port, stats, dict(rtol=1e-4, atol=1e-5))
