"""The stems at every input width the configs give: 7 channels (xyz, rgb,
height), 10 with ``use_normal`` and 135 with ``use_multiview`` (the 128
ENet channels), against the JAX package, on the CPU.

* The dW-only backward of a 135-channel stem, which raised before the stem
  kernels took any width (``conv_dw`` refused Cin > 128 on every device).
* The plain twins of K1 (``gather_conv``) and K3 (``conv_dw``) at Cin 10
  and 135 against the JAX package's XLA gather path
  (``instancerefer_tpu/ops/sparse.gather_conv`` and its VJP), f32: 1e-5 of
  the largest value for K1, 1e-4 for dW (a sum over every row).
* ``route`` on a ``"cuda"`` device object (no card needed): the stem
  kernels at Cin 7, 10 and 135; the stem route's rows (``stem_channels``,
  ``stem_depth``, K3's depth blocks), the stems' input padded to 16-byte
  rows only there (``stem_input``), and the split rule of K3's dW: at most
  ``DW_PARTIAL_BYTES`` of partials, from the shapes and the card's SMs
  alone.
* One train step of a ``use_normal`` and of a ``use_multiview`` config on a
  ``tests/fake_scanrefer.make_fake_root`` root, the batch built by the JAX
  package's loader with the config's features: the port's
  ``solver.train_step`` against the JAX model's ``value_and_grad`` on the
  same batch and weights; the loss at rtol 1e-4 and every parameter
  gradient by ``tests/test_torch_train.py``'s per-layer rule.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.data import dataset as jdataset
from instancerefer_tpu.data.pipeline import batch_to_device_dict
from instancerefer_tpu.models.instancerefer import InstanceRefer as JaxModel
from instancerefer_tpu.ops import sparse as jsparse
from instancerefer_tpu.train.losses import get_loss as jax_loss

from instancerefer_tpu_torch.data import dataset
from instancerefer_tpu_torch.data.host import batch_to_torch
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.ops import conv_bwd, gather_conv, precision, sparse, sparse_conv
from instancerefer_tpu_torch.train import solver
from instancerefer_tpu_torch.utils.convert import state_dict_from_jax

from fake_scanrefer import make_fake_root
from test_torch_host_pipeline import assert_same_batch, jax_spec
from test_torch_train import MEAN_SIZE, _check_gradients, _np_tree

WIDTHS = {"use_normal": 10, "use_multiview": 135}


def _stem_inputs(cin, seed, v_in=300, v_out=260):
    """A 27-offset map (40% valid, a 64-row tile of padding rows), x, W, g."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, v_in, size=(v_out, 27)).astype(np.int32)
    nbr[rng.random(nbr.shape) >= 0.4] = -1
    nbr[64:128] = -1
    x = rng.normal(size=(v_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, 32)) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.normal(size=(v_out, 32)).astype(np.float32)
    return nbr, x, w, g


def test_dw_only_backward_of_a_135_channel_stem():
    """``subm_conv(x [50, 135], nbr [50, 27], w [27, 135, 32],
    grad_input=False)``: its backward raised ``conv_dw: ... disagree``;
    now dX is zero and dW is the twin's."""
    nbr, x, w, g = _stem_inputs(135, 0, v_in=50, v_out=50)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_(True)
    out = sparse_conv.subm_conv(xt, torch.from_numpy(nbr), wt, grad_input=False)
    assert out.shape == (50, 32)
    out.backward(torch.from_numpy(g))
    want = sparse.conv_dw(xt, torch.from_numpy(nbr), torch.from_numpy(g))
    assert wt.grad.shape == (27, 135, 32) and torch.equal(wt.grad, want)


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("cin", sorted(WIDTHS.values()))
def test_k1_twin_matches_jax_gather_path(cin):
    nbr, x, w, _ = _stem_inputs(cin, cin)
    want = np.asarray(jsparse.gather_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w)))
    got = gather_conv.gather_conv(*(torch.from_numpy(a) for a in (x, nbr, w)))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    assert not got[64:128].any()  # padding rows: no neighbour, a zero sum


@pytest.mark.parametrize("cin", sorted(WIDTHS.values()))
def test_k3_twin_matches_jax_gather_path(cin):
    nbr, x, w, g = _stem_inputs(cin, cin + 1)
    _, vjp = jax.vjp(lambda k: jsparse.gather_conv(jnp.asarray(x), jnp.asarray(nbr), k),
                     jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    got = conv_bwd.conv_dw(*(torch.from_numpy(a) for a in (x, nbr, g)))
    assert got.shape == (27, cin, 32) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("cin, want", [(7, "stem_wide"), (10, "stem_wide"), (32, "tensor_core"),
                                       (135, "stem_wide")])
def test_route_of_the_stem_widths(cin, want):
    cuda = torch.device("cuda")
    assert gather_conv.route(torch.bfloat16, cin, cuda) == want
    assert gather_conv.route(torch.float32, cin, cuda) == "fma"
    assert gather_conv.route(torch.bfloat16, cin, torch.device("cpu")) == "twin"


@pytest.mark.parametrize("cin, channels, depth, blocks", [
    (7, 8, 224, 1), (8, 8, 224, 1), (10, 16, 432, 1), (135, 136, 3680, 5), (200, 200, 5408, 8)])
def test_stem_depth_chunks(cin, channels, depth, blocks):
    """The stem kernels' rows and depth: rows padded to 16 bytes, and K3
    puts the depth on its grid in blocks of 768, which the build passes to
    the kernel's source (``NVCC_FLAGS``), where a static_assert holds it to
    the kernel's warps."""
    assert gather_conv.stem_channels(cin) == channels
    assert gather_conv.stem_depth(cin) == depth
    assert depth % 16 == 0 and 27 * channels <= depth < 27 * channels + 16
    assert gather_conv.stem_depth_blocks(cin) == blocks
    block = gather_conv.STEM_DW_BLOCK
    assert (blocks - 1) * block < depth <= blocks * block
    assert f"-DIRSC_STEM_DW_BLOCK={block}" in gather_conv.NVCC_FLAGS


SMS = 132  # an H100's SMs


def _k3_splits(rows, cin, cout, path):
    """The split count ``conv_dw`` takes on ``path`` on an H100, as it
    computes it."""
    if path == "stem_wide":
        per_split = cout // 32 * gather_conv.stem_depth_blocks(cin)
        return conv_bwd.dw_splits(rows, per_split, path, 4 * 27 * cin * cout, SMS)
    return conv_bwd.dw_splits(rows, 27, path, 4 * 27 * cin * cout)


def test_dw_split_rule_caps_the_partials():
    """The scene stem's 581632 rows: fewer splits as Cin grows, and never
    more than DW_PARTIAL_BYTES of partials, on every route; on the stem
    route one block an SM in one wave, and the route refuses to split
    without the card's SM count; a function of the shapes and the card
    alone."""
    cap = conv_bwd.DW_PARTIAL_BYTES
    assert _k3_splits(581632, 7, 32, "stem_wide") == SMS
    assert _k3_splits(581632, 10, 32, "stem_wide") == SMS
    assert _k3_splits(581632, 135, 32, "stem_wide") * 5 <= SMS
    with pytest.raises(ValueError, match="SM count"):
        conv_bwd.dw_splits(581632, 1, "stem_wide")
    for path in ("stem_wide", "fma"):
        prev = None
        for cin in (7, 10, 64, 135, 300, 1000):
            s = _k3_splits(581632, cin, 32, path)
            assert 1 <= s and s * 4 * 27 * cin * 32 <= max(cap, 4 * 27 * cin * 32)
            assert prev is None or s <= prev
            assert s == _k3_splits(581632, cin, 32, path)
            prev = s
    assert _k3_splits(581632, 135, 32, "stem_wide") * 4 * 27 * 135 * 32 < 16e6  # not 233 MB
    # a partial larger than the cap alone still gets one split
    assert conv_bwd.dw_splits(10 ** 6, 1, "fma", cap + 1) == 1
    # the downs' and the residuals' splits are the rows' and blocks' rule
    assert conv_bwd.dw_splits(16384, 8, "tensor_core", 4 * 8 * 128 * 128) == 32
    assert conv_bwd.dw_splits(40960, 27, "tensor_core") == 19


@pytest.mark.parametrize("cin", sorted(WIDTHS.values()))
def test_k3_wrapper_takes_any_width_on_the_cpu(cin):
    nbr, x, _, g = _stem_inputs(cin, 2 * cin)
    before = conv_bwd.conv_dw.launches
    args = [torch.from_numpy(a).bfloat16() if a.dtype == np.float32 else torch.from_numpy(a)
            for a in (x, nbr, g)]
    got = conv_bwd.conv_dw(*args)
    assert torch.equal(got, sparse.conv_dw(*args)) and conv_bwd.conv_dw.launches == before


@pytest.mark.parametrize("cin", [7, 10, 135])
def test_stem_input_pads_only_for_the_wide_kernels(monkeypatch, cin):
    """``stem_input``: the cast copy as before on the CPU (the twin) and in
    f32; where the route is the stem kernels', one bf16 copy of 16-byte
    rows whose padding channels are zero.  A dW-only stem backward from
    those rows gives dW [27, Cin, 32], the twin's."""
    nbr, x, w, g = _stem_inputs(cin, 3 * cin, v_in=80, v_out=80)
    xt, nbr, g = torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(g)
    assert torch.equal(sparse_conv.stem_input(xt), xt)  # f32: no copy
    precision.set_compute_dtype("bfloat16")
    try:
        got = sparse_conv.stem_input(xt)
        assert got.dtype == torch.bfloat16 and torch.equal(got, xt.bfloat16())
        monkeypatch.setattr(sparse_conv, "route", lambda dtype, c, device: gather_conv.route(
            dtype, c, "cuda"))
        got = sparse_conv.stem_input(xt)
        cp = {7: 8, 10: 16, 135: 136}[cin]
        assert got.shape == (80, cp) and got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got[:, :cin], xt.bfloat16()) and not got[:, cin:].any()
        wt = torch.from_numpy(w).requires_grad_(True)
        out = sparse_conv.subm_conv(got, nbr, wt, grad_input=False)
        out.float().backward(g)
    finally:
        precision.set_compute_dtype(None)
    want = sparse.conv_dw(xt.bfloat16(), nbr, g.bfloat16()).bfloat16().float()
    assert wt.grad.shape == (27, cin, 32) and torch.equal(wt.grad, want)


# ----------------------------------------------------------------- train steps
B = 4
# every point of the fake scenes (800 each).  A step is a test of the port
# only where it is well conditioned: at a 500-point draw of use_multiview's
# scenes a 1e-6 relative perturbation of the weights moved the port's own
# gradient of the instance encoder's stage-1 kernel by 2% of its layer's
# largest (a max-pool winner or ReLU sign flipping), at 800 by 1e-5.
NUM_POINTS = 800


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr_widths")
    make_fake_root(root, np.random.default_rng(0))
    return str(root)


def _batches(root, config):
    """The first val batch of the config's features: the port's loader and
    the JAX package's in raster order must agree bit for bit; the JAX
    loader's batch in its XLA order (no band metadata, so the JAX model
    takes its gather path) is what both train steps take.  Returns (that
    batch, the port's spec, the JAX spec)."""
    spec = dataclasses.replace(TEST_SPEC, feat_dim=WIDTHS[config], lang_bucket=8)
    xla = dataclasses.replace(jax_spec(spec), pallas_conv=False)
    out = []
    for mod, s in ((dataset, spec), (jdataset, jax_spec(spec)), (jdataset, xla)):
        ds = mod.ScannetReferenceDataset(mod.get_scanrefer(root, "val"), "val", data_root=root,
                                         num_points=NUM_POINTS, use_augment=False, **{config: True})
        out.append(next(iter(mod.PaddedLoader(ds, s, B, shuffle=False, num_workers=1))))
    assert_same_batch(out[0], out[1])
    return out[2], spec, xla


@pytest.mark.parametrize("config", sorted(WIDTHS))
def test_train_step_matches_jax(fake_root, config):
    batch, spec, jspec = _batches(fake_root, config)
    cin = WIDTHS[config]
    jdd = batch_to_device_dict(batch, jspec)
    model = JaxModel(input_feature_dim=cin, num_classes=spec.num_classes,
                     max_candidates=spec.max_candidates, dropout_override=0.0)
    v = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jdd)
    ms = jnp.asarray(MEAN_SIZE, jnp.float32)

    @jax.jit
    def step(params, stats, dd):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, dd, train=True,
                                   bn_momentum=0.1, rngs={"dropout": jax.random.key(0)},
                                   mutable=["batch_stats"])
            return jax_loss(out, ms)["loss"], upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads, new_stats

    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    loss, grads, _ = step(params, stats, jdd)
    port = InstanceRefer(cin, spec.num_classes, spec.max_candidates, dropout_override=0.0)
    port.load_state_dict(state_dict_from_jax(params, stats))
    assert port.attribute.net.stem[0].net[0].kernel.shape == (27, cin, 32)
    opt = solver.make_optimizer(port.parameters(), 1e-3, 1e-5)
    metrics, _ = solver.train_step(port, opt, batch_to_torch(batch, spec, "cpu"),
                                   torch.tensor(MEAN_SIZE, dtype=torch.float32))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-4)
    tg = {n: p.grad for n, p in port.named_parameters()}
    wg = state_dict_from_jax(_np_tree(grads), stats)
    _check_gradients(tg, wg, 2e-3)
    for enc in ("attribute.net", "scene.net"):
        assert tg[f"{enc}.stem.0.net.0.kernel"].abs().max() > 0
