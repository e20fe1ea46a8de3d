"""The reference's unused loss variants and the named loss pieces of the
port (``train/losses.py``) against the JAX package's, in float32: values,
and the gradients of ``torch.autograd`` against ``jax.grad``, within 1e-5
of the largest magnitude (sums in another order).  The inputs have padded
slots, a row with no positive, a row with more than 20 negatives (of which
``ranking_loss`` keeps 10) and one with fewer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.ops import boxes as jax_boxes
from instancerefer_tpu.ops import sparse as jax_sparse
from instancerefer_tpu.train import losses as J

from instancerefer_tpu_torch.ops.boxes import np_box3d_iou_aabb
from instancerefer_tpu_torch.ops.sparse import masked_mean
from instancerefer_tpu_torch.train import losses as P

RTOL = 1e-5
B, C = 6, 32


def candidates(rng):
    """sim [B, C] f32, label [B, C] f32, mask [B, C] bool: row 0 has 31
    negatives, row 1 no positive, row 2 10 valid slots, row 3 a label of
    0.3 (neither side), rows 4-5 random padding."""
    sim = rng.uniform(-1, 1, size=(B, C)).astype(np.float32)
    label = np.zeros((B, C), np.float32)
    label[np.arange(B), rng.integers(0, 8, size=B)] = 1.0
    label[1] = 0.0
    label[3, 9] = 0.3
    mask = np.ones((B, C), bool)
    mask[2, 10:] = False
    mask[4:] = rng.random((2, C)) < 0.7
    mask[4:, :8] = True
    return sim, label, mask


def scene_dict(rng):
    return {
        "seg_scores": rng.normal(size=(B, 9)).astype(np.float32),
        "ref_center_label": rng.uniform(0, 4, size=(B, 3)).astype(np.float32),
        "point_min": np.zeros((B, 3), np.float32),
        "point_max": np.full((B, 3), 4.0, np.float32),
        "lang_scores": rng.normal(size=(B, 18)).astype(np.float32),
        "object_cat": rng.integers(0, 18, size=B).astype(np.int32),
    }


def _scalar(out, xp):
    outs = out if isinstance(out, tuple) else (out,)
    return sum((i + 1) * o.sum() for i, o in enumerate(outs) if xp.issubdtype(o.dtype, xp.floating))


def _jax_case(fn, args, diff):
    def f(*d):
        full = list(args)
        for i, x in zip(diff, d):
            full[i] = x
        return fn(*full)

    j_args = [jnp.asarray(a) for a in args]
    out = f(*[j_args[i] for i in diff])
    grads = jax.grad(lambda *d: _scalar(f(*d), jnp), argnums=tuple(range(len(diff))))(
        *[j_args[i] for i in diff])
    return out, grads


def _torch_case(fn, args, diff):
    t_args = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in diff:
        t_args[i].requires_grad_(True)
    out = fn(*t_args)
    scalar = sum((i + 1) * o.sum() for i, o in enumerate(out if isinstance(out, tuple) else (out,))
                 if o.is_floating_point())
    grads = torch.autograd.grad(scalar, [t_args[i] for i in diff])
    return out, grads


def assert_close(got, want, where):
    g, w = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want)
    assert g.shape == w.shape, where
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=where)
        return
    assert np.isfinite(w).all(), where
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= RTOL * scale, (where, np.abs(g - w).max(), scale)


def variant_cases(rng):
    """name -> (jax fn, port fn, numpy args, indices of the differentiated)."""
    sim, label, mask = candidates(rng)
    preds = rng.normal(size=(B * C,)).astype(np.float32) * 3
    seg_labels = (rng.random(B * C) < 0.3).astype(np.float32)
    box = [rng.normal(size=(B, 3)).astype(np.float32) * 1.5 for _ in range(4)]
    box_mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    dd = scene_dict(rng)
    valid = np.array([1, 1, 1, 0, 1, 0], bool)
    scene_keys = ("seg_scores", "ref_center_label", "point_min", "point_max")
    lang_keys = ("lang_scores", "object_cat")

    def on_dict(fn, keys):
        return lambda *a: fn(dict(zip(keys, a[:-1])), a[-1])

    return {
        "softmax_ranking_loss": (J.softmax_ranking_loss, P.softmax_ranking_loss,
                                 (sim, label, mask), (0,)),
        "simclr_loss": (J.simclr_loss, P.simclr_loss, (sim, label, mask), (0,)),
        "ranking_loss": (J.ranking_loss, P.ranking_loss, (sim, label, mask), (0,)),
        "seg_focal_loss": (J.seg_focal_loss, P.seg_focal_loss,
                           (preds, seg_labels, rng.random(B * C) < 0.8), (0,)),
        "compute_box_loss": (J.compute_box_loss, P.compute_box_loss, (*box, box_mask), (0, 1)),
        "cross_entropy": (J.cross_entropy, lambda x, y: P.cross_entropy(x, y.long()),
                          (dd["lang_scores"], dd["object_cat"]), (0,)),
        "compute_scene_mask_loss": (on_dict(J.compute_scene_mask_loss, scene_keys),
                                    on_dict(P.compute_scene_mask_loss, scene_keys),
                                    (*[dd[k] for k in scene_keys], valid), (0,)),
        "compute_lang_classification_loss": (
            on_dict(J.compute_lang_classification_loss, lang_keys),
            lambda x, y, v: P.compute_lang_classification_loss(
                {"lang_scores": x, "object_cat": y.long()}, v),
            (*[dd[k] for k in lang_keys], valid), (0,)),
    }


NAMES = sorted(variant_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", NAMES)
def test_value_and_gradients_match_jax(name):
    jax_fn, port_fn, args, diff = variant_cases(np.random.default_rng(4))[name]
    j_out, j_grads = _jax_case(jax_fn, args, diff)
    t_out, t_grads = _torch_case(port_fn, args, diff)
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(j_outs) == len(t_outs)
    for k, (g, w) in enumerate(zip(t_outs, j_outs)):
        assert_close(g, w, f"{name} output {k}")
    for i, g, w in zip(diff, t_grads, j_grads):
        assert_close(g, w, f"{name} d/d arg {i}")
        assert np.abs(np.asarray(w)).max() > 0, f"{name}: a zero gradient checks nothing"


def test_ranking_loss_keeps_ten_of_many_negatives():
    """Row 0 (31 negatives) keeps its 10 largest: lowering its 11th largest
    negative (below the cut) moves nothing; lowering its largest does."""
    sim, label, mask = candidates(np.random.default_rng(4))
    row = sim[0].copy()
    neg = np.flatnonzero(label[0] < 0.25)
    order = neg[np.argsort(-row[neg])]
    base = P.ranking_loss(*map(torch.from_numpy, (sim, label, mask)))
    for idx, moves in ((order[10], False), (order[0], True)):
        s = sim.copy()
        s[0, idx] -= 0.05
        loss = P.ranking_loss(*map(torch.from_numpy, (s, label, mask)))
        assert bool(loss != base) == moves


def test_np_box3d_iou_aabb_matches_jax(rng):
    a = np.concatenate([rng.normal(size=(5, 4, 3)), rng.uniform(0.1, 2, size=(5, 4, 3)),
                        np.zeros((5, 4, 1))], -1)
    b = a[:, :1] + np.concatenate([rng.normal(size=(5, 1, 3)) * 0.3, np.zeros((5, 1, 4))], -1)
    np.testing.assert_array_equal(np_box3d_iou_aabb(a, b), jax_boxes.np_box3d_iou_aabb(a, b))


@pytest.mark.parametrize("shape,axis", [((7, 5), 0), ((4, 6, 3), 1), ((5,), 0)])
def test_masked_mean_matches_jax(rng, shape, axis):
    feats = rng.normal(size=shape).astype(np.float32)
    mask = rng.random(shape[:axis + 1]) < 0.6
    mask.reshape(-1)[0] = False
    want = jax_sparse.masked_mean(jnp.asarray(feats), jnp.asarray(mask), axis=axis)
    got = masked_mean(torch.from_numpy(feats), torch.from_numpy(mask), axis=axis)
    assert_close(got, want, f"masked_mean {shape} axis {axis}")
