"""Weights in the reference's layout (``utils/convert``) and ``use_bidir``,
against the JAX package.

* ``to_reference_state_dict`` of JAX-carried weights equals the JAX
  exporter's ``export_state_dict``, key for key and bit for bit.
* A reference-layout ``.pth`` (the exporter's output through ``torch.save``)
  loaded with ``load_reference_state_dict`` gives the JAX model's eval
  forward: rtol 1e-4 / atol 1e-5 on valid rows, as ``tests/test_torch_slice.py``.
* The kernel-order trap: the port indexes sparse kernels in the host maps'
  offset order, the reference in torchsparse's.  Both are x-fastest today
  (the exporter's permutations are the identity), so a bare
  ``load_state_dict`` of a reference file is right, and the test says so.
  Under any other order it loads without complaint and computes something
  else, while ``load_reference_state_dict`` stays right: shown with the
  exporter's permutation reversed.
* ``use_bidir=False`` (a one-direction GRU, heads 128 wide): the language
  module and the whole model against JAX's with the same flag.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.models import lang_module as jlang
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.train.evaluate import get_eval as jax_eval
from instancerefer_tpu.train.losses import get_loss as jax_loss
from instancerefer_tpu.utils import convert_torch
from instancerefer_tpu.utils.convert_torch import export_state_dict

from instancerefer_tpu_torch.config import Config
from instancerefer_tpu_torch.data.host import TEST_SPEC, batch_to_torch, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer, build_model
from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss
from instancerefer_tpu_torch.utils.convert import (
    load_reference_state_dict,
    state_dict_from_jax,
    to_reference_state_dict,
)

from test_torch_modules import perturb_stats

SPEC = TEST_SPEC
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
KEYS = ("lang_scores", "attribute_scores", "relation_scores", "scene_scores", "seg_scores",
        "loss", "ref_iou")
CAND_KEYS = ("attribute_scores", "relation_scores", "scene_scores")


@pytest.fixture(scope="module", params=[True, False], ids=["bidir", "one_direction"])
def jax_side(request, tmp_path_factory):
    """JAX weights (BN statistics moved off their defaults), their forward on
    one batch, and the reference-layout ``.pth`` the exporter gives."""
    use_bidir = request.param
    batch = make_batch(4, SPEC, seed=2, mean_size_arr=MEAN_SIZE)
    jdd = batch_to_device_dict(batch, SPEC)
    model = JaxModel(input_feature_dim=SPEC.feat_dim, num_classes=SPEC.num_classes,
                     max_candidates=SPEC.max_candidates, use_bidir=use_bidir)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jdd)
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    stats = perturb_stats(jax.device_get(v["batch_stats"]), 5)

    @jax.jit
    def run(variables, dd):
        out = jax_eval(jax_loss(model.apply(variables, dd, train=False), jnp.asarray(MEAN_SIZE)))
        return {k: out[k] for k in KEYS + ("score_mask",)}

    want = jax.tree.map(np.asarray, run({"params": params, "batch_stats": stats}, jdd))
    ref = export_state_dict(params, stats)
    pth = tmp_path_factory.mktemp("ckpt") / "model_last.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, pth)
    return dict(use_bidir=use_bidir, batch=batch, params=params, stats=stats, want=want,
                ref=ref, pth=pth)


def _port(jax_side):
    return InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                         use_bidir=jax_side["use_bidir"]).eval()


def _forward(model, batch):
    with torch.no_grad():
        out = get_eval(get_loss(model(batch_to_torch(batch, SPEC, "cpu")),
                                torch.tensor(MEAN_SIZE, dtype=torch.float32)))
    return {k: out[k].numpy() for k in KEYS}


def _mismatch(got, want):
    """The first key on which the port and JAX disagree, or None; the
    candidate scores are compared on scored candidates only."""
    cand = want["score_mask"]
    for k in KEYS:
        g, w = (got[k][cand], want[k][cand]) if k in CAND_KEYS else (got[k], want[k])
        if not np.allclose(g, w, rtol=1e-4, atol=1e-5):
            return k
    return None


def test_to_reference_state_dict_equals_the_exporter(jax_side):
    port = _port(jax_side)
    port.load_state_dict(state_dict_from_jax(jax_side["params"], jax_side["stats"]))
    got, want = to_reference_state_dict(port), jax_side["ref"]
    assert list(got) == list(port.state_dict()) and set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_reference_pth_loads_to_the_jax_forward(jax_side):
    port = _port(jax_side)
    load_reference_state_dict(port, torch.load(jax_side["pth"], weights_only=True))
    want = jax_side["want"]
    assert want["score_mask"].any()
    assert _mismatch(_forward(port, jax_side["batch"]), want) is None
    # and it writes the same file back
    for k, v in to_reference_state_dict(port).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_side["ref"][k]), err_msg=k)


def test_offset_orders_coincide_today(jax_side):
    assert (convert_torch._PERM3 == np.arange(27)).all()
    assert (convert_torch._PERM2 == np.arange(8)).all()
    port = _port(jax_side)
    port.load_state_dict(torch.load(jax_side["pth"], weights_only=True))
    assert _mismatch(_forward(port, jax_side["batch"]), jax_side["want"]) is None


def test_bare_load_state_dict_is_wrong_when_the_orders_differ(jax_side, monkeypatch, tmp_path):
    """Kernel-order regression: with the reference's offsets in another
    order, a bare ``load_state_dict`` of its file loads "fine" and computes
    wrong scores; ``load_reference_state_dict`` does not."""
    monkeypatch.setattr(convert_torch, "_PERM3", np.arange(27)[::-1].copy())
    monkeypatch.setattr(convert_torch, "_PERM2", np.arange(8)[::-1].copy())
    pth = tmp_path / "reversed.pth"
    ref = export_state_dict(jax_side["params"], jax_side["stats"])
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref.items()}, pth)
    want = jax_side["want"]
    bare = _port(jax_side)
    bare.load_state_dict(torch.load(pth, weights_only=True))
    got = _forward(bare, jax_side["batch"])
    np.testing.assert_allclose(got["lang_scores"], want["lang_scores"], rtol=1e-4, atol=1e-5)
    assert _mismatch(got, want) == "attribute_scores"
    port = _port(jax_side)
    load_reference_state_dict(port, torch.load(pth, weights_only=True))
    assert _mismatch(_forward(port, jax_side["batch"]), want) is None
    for k, v in to_reference_state_dict(port).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


def test_lang_module_one_direction_matches_flax():
    batch = make_batch(3, SPEC, seed=4)
    jdd = batch_to_device_dict(batch, SPEC)
    mod = jlang.LangModule(num_text_classes=SPEC.num_classes, use_bidir=False)
    inputs = {k: jdd[k] for k in ("lang_feat", "lang_len")}
    v = jax.jit(functools.partial(mod.init, train=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, inputs)
    params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
    want = jax.jit(lambda p, d: mod.apply({"params": p}, d, train=False))(params, inputs)
    port = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates, use_bidir=False)
    assert port.lang.gru.bidirectional is False and port.lang.fc_a.in_features == 128
    sd = {k[len("lang."):]: t for k, t in state_dict_from_jax({"lang": params}, {}).items()}
    port.lang.load_state_dict(sd)
    tdd = batch_to_torch(batch, SPEC, "cpu")
    with torch.no_grad():
        got = port.lang.eval()({k: tdd[k] for k in ("lang_feat", "lang_len")})
    assert got["lang_feat"].shape[-1] == 128
    for k in ("lang_scores", "lang_feat", "lang_cls_feats", "atten_attr", "atten_rel",
              "atten_scene"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("key", ["attribute_module", "relation_module", "scene_module"])
def test_build_model_refuses_a_module_switched_off(key):
    cfg = Config(**{key: None})
    with pytest.raises(ValueError, match=key):
        build_model(cfg)
    model = build_model(Config(use_bidir=False, k=4, max_candidates=8))
    assert model.lang.gru.bidirectional is False and model.relation.gcn.k == 4
