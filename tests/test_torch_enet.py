"""The port's ENet (``instancerefer_tpu_torch/models/enet.py``) against the
flax ``Enet`` of the JAX package.

One random state dict under the reference's keys (the port's own, with its
BatchNorm affine and running statistics moved off their defaults) goes to
the JAX side through ``scripts/convert_enet.convert_state_dict`` and to the
port through a strict ``load_state_dict``.  64 x 80 frames from a seed;
features and logits within 1e-4 max abs, the limit of
``tests/test_enet_convert.py`` (f32, sums in another order).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.convert_enet import convert_state_dict  # noqa: E402

from instancerefer_tpu.models import enet as jenet  # noqa: E402

from instancerefer_tpu_torch.models import enet  # noqa: E402
from instancerefer_tpu_torch.utils.convert import enet_state_dict_from_jax, load_enet  # noqa: E402


def random_state_dict(seed: int = 0):
    """The port's ENet state dict with every tensor drawn from ``seed`` by
    numpy: convs normal at torch's default scale (1 / sqrt(3 fan_in)), conv
    biases normal, PReLU slopes in [0, 0.5], BatchNorm scale and variance in
    [0.5, 1.5], shift and mean in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    model = enet.Enet()

    def draw(t, fn):
        t.copy_(torch.from_numpy(fn(tuple(t.shape)).astype(np.float32)))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                draw(m.weight, lambda s: rng.uniform(0.5, 1.5, s))
                draw(m.bias, lambda s: rng.uniform(-0.5, 0.5, s))
                draw(m.running_mean, lambda s: rng.uniform(-0.5, 0.5, s))
                draw(m.running_var, lambda s: rng.uniform(0.5, 1.5, s))
            elif isinstance(m, torch.nn.Conv2d):
                draw(m.weight, lambda s: rng.normal(size=s) * (3.0 * np.prod(s[1:])) ** -0.5)
                if m.bias is not None:
                    draw(m.bias, lambda s: rng.normal(scale=0.2, size=s))
            elif isinstance(m, torch.nn.PReLU):
                draw(m.weight, lambda s: rng.uniform(0.0, 0.5, s))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def weights():
    sd = random_state_dict()
    return sd, convert_state_dict({k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def outputs(weights):
    sd, variables = weights
    x = np.random.default_rng(1).normal(size=(2, 64, 80, 3)).astype(np.float32)
    logits_j, feats_j = jax.jit(lambda v, x: jenet.Enet().apply(v, x, train=False))(
        variables, jnp.asarray(x))
    model = enet.Enet()
    model.load_state_dict(sd)  # strict
    with torch.no_grad():
        logits_t, feats_t = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (np.asarray(logits_j).transpose(0, 3, 1, 2), np.asarray(feats_j).transpose(0, 3, 1, 2),
            logits_t.numpy(), feats_t.numpy())


def test_features_match_flax(outputs):
    _, feats_j, _, feats_t = outputs
    assert feats_t.shape == (2, 128, 8, 10)
    assert 0.1 < np.abs(feats_j).max() < 100  # the weights make the net discriminate
    np.testing.assert_allclose(feats_t, feats_j, rtol=0, atol=1e-4)


def test_logits_match_flax(outputs):
    logits_j, _, logits_t, _ = outputs
    assert logits_t.shape == (2, 41, 8, 10)
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=1e-4)


def test_features_alone_equal_the_full_pass(weights, outputs):
    sd, _ = weights
    model = enet.Enet().eval()
    model.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, 80, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model.features(x.permute(0, 3, 1, 2)), torch.from_numpy(outputs[3]))


def test_key_set_is_the_converters(weights):
    """Every key of the port's state dict is one ``convert_state_dict``
    reads: the flax tree it builds has the structure of the flax model's
    own init, and as many values as the state dict (BatchNorm counters
    aside)."""
    sd, variables = weights
    init = jax.jit(functools.partial(jenet.Enet().init, train=False))(
        jax.random.key(0), jnp.zeros((1, 64, 80, 3)))
    for col in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(init[col]) == \
            jax.tree_util.tree_structure(variables[col])
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    n_torch = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_flax == n_torch
    assert {k.split(".")[0] for k in sd} == {str(i) for i in (0, 2, 3, *range(4, 27))}


def test_state_dict_from_jax_round_trips(weights):
    sd, variables = weights
    back = enet_state_dict_from_jax(variables)
    assert list(sorted(back)) == list(sorted(sd))
    for key, value in sd.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key
    enet.Enet().load_state_dict(back)  # strict


def test_load_enet_is_a_plain_strict_load(weights, tmp_path):
    sd, _ = weights
    path = tmp_path / "enet.pth"
    torch.save(sd, path)
    model = load_enet(str(path))
    assert not model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    torch.save({k: v for k, v in sd.items() if k != "26.0.weight"}, path)
    with pytest.raises(RuntimeError, match="26.0.weight"):
        load_enet(str(path))


def test_normalize_frame_matches():
    x = np.random.default_rng(2).uniform(size=(5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(enet.normalize_frame(torch.from_numpy(x)).numpy(),
                               np.asarray(jenet.normalize_frame(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_plan_and_dropout_match_jax():
    assert enet.BOTTLENECK_PLAN == jenet.BOTTLENECK_PLAN
    drop = enet.TorchLuaDropout(0.1)
    x = torch.ones(1000)
    assert torch.equal(drop.eval()(x), torch.full_like(x, 0.9))  # (1 - p) at eval
    torch.manual_seed(0)
    y = drop.train()(x)
    assert set(y.unique().tolist()) <= {0.0, 1.0}  # kept: (1 - p) / (1 - p)
