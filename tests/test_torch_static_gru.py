"""The port's static-shape GRU (``instancerefer_tpu_torch/ops/gru.static_gru``,
what the language module runs) against the packed one it replaces
(``packed_gru``, ``pack_padded_sequence`` over ``nn.GRU``) and against the
JAX package's masked scan (``instancerefer_tpu/ops/gru.MaskedGRU``), both
directions and one, on the grids a batch takes (T = 32 and T = 126) with
lengths 0, 1, 5 and T.

Outputs and gradients (of a random projection of the outputs, with respect
to the input and every GRU parameter) agree within atol 1e-5 in f32: the
three compute the same recurrences with sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.ops.gru import MaskedGRU

from instancerefer_tpu_torch.models.lang_module import LangModule
from instancerefer_tpu_torch.ops import gru

ATOL = 1e-5
C, H = 6, 5
NAMES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _case(bidir, t, seed=0):
    torch.manual_seed(seed)
    tg = torch.nn.GRU(C, H, num_layers=2, batch_first=True, bidirectional=bidir)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, t, C)).astype(np.float32)
    lengths = np.array([0, 1, 5, t])
    proj = rng.normal(size=(4, t, H * (1 + bidir))).astype(np.float32)
    return tg, x, lengths, proj


def _torch_run(fn, tg, x, lengths, proj):
    """(outputs, d/dx, {param name: d/dparam}) of sum(fn(...) * proj)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(tg, xt, torch.from_numpy(lengths))
    params = dict(tg.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), [xt, *params.values()])
    return (out.detach().numpy(), grads[0].numpy(),
            {n: g.numpy() for n, g in zip(params, grads[1:])})


def _jax_params(tg):
    params = {}
    for layer in range(tg.num_layers):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse"))[:1 + tg.bidirectional]:
            g = lambda n: getattr(tg, f"{n}_l{layer}{sfx}").detach().numpy()  # noqa: E731
            params[f"l{layer}_{d}"] = {"wx": g("weight_ih").T, "wh": g("weight_hh").T,
                                       "bx": g("bias_ih"), "bh": g("bias_hh")}
    return params


def _jax_run(tg, x, lengths, proj):
    """The same three results from ``MaskedGRU``, its gradients named as
    the torch module's parameters."""
    mod = MaskedGRU(hidden_size=H, bidirectional=tg.bidirectional)

    def loss(p, xx):
        return jnp.sum(mod.apply({"params": p}, xx, lengths) * proj)

    params = jax.tree.map(jnp.asarray, _jax_params(tg))
    x = jnp.asarray(x)
    out = np.asarray(mod.apply({"params": params}, x, lengths))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    named = {}
    for layer in range(tg.num_layers):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse"))[:1 + tg.bidirectional]:
            g = gp[f"l{layer}_{d}"]
            named.update({f"weight_ih_l{layer}{sfx}": np.asarray(g["wx"]).T,
                          f"weight_hh_l{layer}{sfx}": np.asarray(g["wh"]).T,
                          f"bias_ih_l{layer}{sfx}": np.asarray(g["bx"]),
                          f"bias_hh_l{layer}{sfx}": np.asarray(g["bh"])})
    return out, np.asarray(gx), named


def _assert_same(got, want):
    out, gx, gp = got
    w_out, w_gx, w_gp = want
    np.testing.assert_allclose(out, w_out, rtol=0, atol=ATOL, err_msg="outputs")
    np.testing.assert_allclose(gx, w_gx, rtol=0, atol=ATOL, err_msg="d/dx")
    assert gp.keys() == w_gp.keys()
    for n in gp:
        np.testing.assert_allclose(gp[n], w_gp[n], rtol=0, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("t", [32, 126])
@pytest.mark.parametrize("bidir", [True, False])
def test_static_gru_matches_packed_gru(bidir, t):
    tg, x, lengths, proj = _case(bidir, t)
    got = _torch_run(gru.static_gru, tg, x, lengths, proj)
    _assert_same(got, _torch_run(gru.packed_gru, tg, x, lengths, proj))
    out = got[0]
    assert np.all(out[0] == 0.0) and np.all(out[1, 1:] == 0.0) and np.all(out[2, 5:] == 0.0)
    assert np.abs(out[3]).min() > 0.0  # a full row is live to its end


@pytest.mark.parametrize("t", [32, 126])
@pytest.mark.parametrize("bidir", [True, False])
def test_static_gru_matches_masked_scan(bidir, t):
    tg, x, lengths, proj = _case(bidir, t, seed=1)
    _assert_same(_torch_run(gru.static_gru, tg, x, lengths, proj), _jax_run(tg, x, lengths, proj))


def test_lang_module_runs_the_static_gru_with_the_modules_parameters():
    """The language module's GRU keeps ``nn.GRU``'s parameters and names
    (checkpoint keys), and its outputs are the packed GRU's."""
    torch.manual_seed(2)
    lang = LangModule(18).eval()
    names = {n for n, _ in lang.gru.named_parameters()}
    assert names == {f"{p}_l{layer}{sfx}" for p in NAMES for layer in (0, 1)
                     for sfx in ("", "_reverse")}
    x = torch.randn(3, 32, 256)
    lengths = torch.tensor([32, 7, 0])
    with torch.no_grad():
        np.testing.assert_allclose(gru.static_gru(lang.gru, x, lengths).numpy(),
                                   gru.packed_gru(lang.gru, x, lengths).numpy(),
                                   rtol=0, atol=ATOL)
