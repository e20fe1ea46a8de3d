"""Each module of the port against its flax counterpart, with the same
weights (``state_dict_from_jax``) on the same numpy inputs, in f32 and eval
mode: the sparse encoders (folded BN), the GRU (pack/pad vs ``MaskedGRU``),
the language, attribute, relation (with kNN) and scene modules, the pooling
and box ops.

Tolerance: f32 on both sides with sums in other orders; each assertion
states its own (1e-5 for single ops, 1e-4 where a deep encoder stacks up).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu.models import attribute_module as jattr
from instancerefer_tpu.models import basic_blocks as jbb
from instancerefer_tpu.models import lang_module as jlang
from instancerefer_tpu.models import relation_module as jrel
from instancerefer_tpu.models import scene_module as jscene
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.ops import boxes as jboxes
from instancerefer_tpu.ops.gru import MaskedGRU
from instancerefer_tpu.ops.knn import knn_padded as jax_knn
from instancerefer_tpu.ops.sparse import masked_global_max_pool as jax_pool

from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.ops import boxes, gru, knn, sparse

from jax_weights import state_dict_from_jax

SPEC = TEST_SPEC
B = 2


def perturb_stats(stats, seed):
    """BN running statistics off their defaults, so the folded affine is
    not the identity."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return (a + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, stats)


@pytest.fixture(scope="module")
def setup():
    batch = make_batch(B, SPEC, seed=1)
    jdd = batch_to_device_dict(batch, SPEC)
    model = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                     max_candidates=SPEC.max_candidates)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jdd
    )
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    stats = perturb_stats(jax.device_get(v["batch_stats"]), 7)
    port = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates).eval()
    port.load_state_dict(state_dict_from_jax(params, stats))
    tdd = batch_to_torch(batch, SPEC, "cpu")
    return dict(batch=batch, jdd=jdd, params=params, stats=stats, port=port, tdd=tdd)


def _vars(s, *path):
    p, st = s["params"], s["stats"]
    for k in path:
        p, st = p[k], st.get(k, {}) if isinstance(st, dict) else {}
    return {"params": p, "batch_stats": st} if st else {"params": p}


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("prefix,module", [("inst", "attribute"), ("scene", "scene")])
def test_encoder_matches_flax(setup, prefix, module):
    enc = jbb.SparseConvEncoder()
    pyr = setup["jdd"][f"{prefix}_pyramid"]
    want = np.asarray(jax.jit(lambda v, f: enc.apply(v, f, pyr, train=False))(
        _vars(setup, module, "net"), setup["jdd"][f"{prefix}_feats"]))
    with torch.no_grad():
        got = _np(getattr(setup["port"], module).net(
            setup["tdd"][f"{prefix}_feats"], setup["tdd"][f"{prefix}_pyramid"]))
    live = np.asarray(pyr[-1].mask)
    assert live.any() and np.abs(want[live]).max() > 0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-4, atol=1e-5)


def test_gru_matches_masked_gru():
    b, t, c, h = 4, 9, 6, 5
    lengths = np.array([9, 5, 1, 0])
    x = np.random.default_rng(0).normal(size=(b, t, c)).astype(np.float32)
    tg = torch.nn.GRU(c, h, num_layers=2, batch_first=True, bidirectional=True)
    params = {}
    for layer in range(2):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            g = lambda n: getattr(tg, f"{n}_l{layer}{sfx}").detach().numpy()  # noqa: E731
            params[f"l{layer}_{d}"] = {"wx": g("weight_ih").T, "wh": g("weight_hh").T,
                                       "bx": g("bias_ih"), "bh": g("bias_hh")}
    want = np.asarray(MaskedGRU(hidden_size=h).apply({"params": params}, x, lengths))
    with torch.no_grad():
        got = _np(gru.packed_gru(tg, torch.from_numpy(x), torch.from_numpy(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[3] == 0.0) and np.all(got[1, 5:] == 0.0)


def test_lang_module_matches_flax(setup):
    mod = jlang.LangModule(num_text_classes=SPEC.num_classes)
    want = jax.jit(lambda v, d: mod.apply(v, d, train=False))(
        _vars(setup, "lang"), {k: setup["jdd"][k] for k in ("lang_feat", "lang_len")})
    with torch.no_grad():
        got = setup["port"].lang({k: setup["tdd"][k] for k in ("lang_feat", "lang_len")})
    for k in ("lang_scores", "lang_feat", "lang_attr_feats", "lang_cls_feats",
              "lang_rel_feats", "lang_scene_feats", "atten_attr", "atten_rel", "atten_scene"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _lang_feats(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(B, 256)).astype(np.float32)
            for k in ("lang_attr_feats", "lang_rel_feats", "lang_scene_feats")}


def test_attribute_module_matches_flax(setup):
    keys = ("inst_pyramid", "inst_feats", "cand_mask")
    jin = {**{k: setup["jdd"][k] for k in keys}, **_lang_feats(1)}
    tin = {**{k: setup["tdd"][k] for k in keys},
           **{k: torch.from_numpy(v) for k, v in _lang_feats(1).items()}}
    mod = jattr.AttributeModule(input_feature_dim=SPEC.feat_dim,
                                max_candidates=SPEC.max_candidates)
    want = jax.jit(lambda v, d: mod.apply(v, d, train=False))(_vars(setup, "attribute"), jin)
    with torch.no_grad():
        got = setup["port"].attribute(tin)
    np.testing.assert_array_equal(_np(got["score_mask"]), np.asarray(want["score_mask"]))
    np.testing.assert_allclose(_np(got["obj_feats"]), np.asarray(want["obj_feats"]),
                               rtol=1e-4, atol=1e-5)
    m = np.asarray(want["score_mask"])
    assert m.any()
    np.testing.assert_allclose(_np(got["attribute_scores"])[m],
                               np.asarray(want["attribute_scores"])[m], rtol=1e-4, atol=1e-5)


def test_relation_module_matches_flax(setup):
    keys = ("instance_mask", "instance_class", "instance_obbs", "instance_node_feat",
            "cand_slot", "cand_mask")
    jin = {**{k: setup["jdd"][k] for k in keys}, **_lang_feats(2)}
    tin = {**{k: setup["tdd"][k] for k in keys},
           **{k: torch.from_numpy(v) for k, v in _lang_feats(2).items()}}
    mod = jrel.RelationModule(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes)
    want = np.asarray(jax.jit(lambda v, d: mod.apply(v, d, train=False))(
        _vars(setup, "relation"), jin)["relation_scores"])
    with torch.no_grad():
        got = _np(setup["port"].relation(tin)["relation_scores"])
    m = np.asarray(setup["jdd"]["cand_mask"])
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_scene_module_matches_flax(setup):
    keys = ("scene_pyramid", "scene_feats", "cand_mask")
    obj = np.random.default_rng(3).normal(size=(B, SPEC.max_candidates, 128)).astype(np.float32)
    jin = {**{k: setup["jdd"][k] for k in keys}, **_lang_feats(3), "obj_feats": obj}
    tin = {**{k: setup["tdd"][k] for k in keys}, "obj_feats": torch.from_numpy(obj),
           **{k: torch.from_numpy(v) for k, v in _lang_feats(3).items()}}
    mod = jscene.SceneModule(input_feature_dim=SPEC.feat_dim)
    want = jax.jit(lambda v, d: mod.apply(v, d, train=False))(_vars(setup, "scene"), jin)
    with torch.no_grad():
        got = setup["port"].scene(tin)
    for k in ("seg_scores", "scene_scores", "vis_atten"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_knn_matches_flax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 5, 3)).astype(np.float32)
    s = rng.normal(size=(3, 12, 3)).astype(np.float32)
    mask = np.ones((3, 12), bool)
    mask[1, 4:] = False  # fewer valid supports than k: slots repeat slot 0
    mask[2] = False  # no valid support at all
    want_idx, want_valid = jax_knn(q, s, mask, 8)
    idx, valid = knn.knn_padded(torch.from_numpy(q), torch.from_numpy(s),
                                torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(_np(idx), np.asarray(want_idx))
    np.testing.assert_array_equal(_np(valid), np.asarray(want_valid))


def test_masked_global_max_pool_matches_flax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    owner = rng.integers(-1, 4, size=40).astype(np.int64)
    owner[owner == 2] = 3  # owner 2 has no rows -> pools to 0
    want = np.asarray(jax_pool(jnp.asarray(feats), jnp.asarray(owner), 5))
    got = _np(sparse.masked_global_max_pool(torch.from_numpy(feats), torch.from_numpy(owner), 5))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[2] == 0.0) and np.all(got[4] == 0.0)


def test_boxes_match_flax():
    rng = np.random.default_rng(6)
    a = np.concatenate([rng.normal(size=(7, 3)), rng.uniform(0.1, 2, (7, 3)),
                        np.zeros((7, 1))], 1).astype(np.float32)
    b = a[::-1].copy()
    b[0] = 0.0  # a zero box
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(_np(boxes.box3d_iou_aabb(ta, tb)),
                               np.asarray(jboxes.box3d_iou_aabb(a, b)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(boxes.get_3d_box_corners(ta)),
                                  np.asarray(jboxes.get_3d_box_corners(jnp.asarray(a))))
    ms = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
    cls = rng.integers(0, 18, size=7)
    res = rng.normal(size=(7, 3)).astype(np.float32)
    want = np.asarray(jboxes.param2obb(jnp.asarray(a[:, :3]), 0, 0, jnp.asarray(cls),
                                       jnp.asarray(res), jnp.asarray(ms, jnp.float32)))
    got = _np(boxes.param2obb(ta[:, :3], 0, 0, torch.from_numpy(cls), torch.from_numpy(res),
                              torch.tensor(ms, dtype=torch.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
