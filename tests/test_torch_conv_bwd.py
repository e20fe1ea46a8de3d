"""The port's sparse-conv backward (instancerefer_tpu_torch/ops/conv_bwd and
ops/sparse_conv) against the JAX package.

* The plain twins of K2 (``sparse.subm_conv_bwd``) and K3
  (``sparse.conv_dw``), which the wrappers run for CPU tensors, against the
  banded Pallas kernels ``windowed_conv_bwd_fused`` / ``windowed_conv_dw``
  in interpret mode, on drop-free banded maps (where the banded kernels are
  exact).
* ``SubmConv``/``DownConv`` against torch autograd of the plain forward,
  the dW-only stem backward, and the bf16 policy's casts against JAX's
  ``banded_subm_conv`` VJP.

Tolerance: f32 on both sides, sums in another order — rtol = atol = 1e-5
(1e-4 for dW, a sum over every row); bf16 results may differ by one bf16
ulp where two f32 sums round apart — 1e-2 of the largest value.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancerefer_tpu.ops import precision as jprecision
from instancerefer_tpu.ops import voxelize as V
from instancerefer_tpu.ops.pallas_conv import (
    banded_subm_conv, windowed_conv_bwd_fused, windowed_conv_dw,
)

from instancerefer_tpu_torch.ops import conv_bwd, gather_conv, sparse, sparse_conv, up_conv
from instancerefer_tpu_torch.ops import precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
DW_TOL = dict(rtol=1e-4, atol=1e-4)
CAP0, CAP1 = 2048, 512
CHUNK, WINDOW, SUBWIN = 128, 512, 384


def _maps(seed, n_samples=2):
    """Stage-1 ``nbr3`` (K = 27, into stage 1), ``down`` (K = 8, into
    stage 0) and its inverse ``up8`` (into stage 1) of raster-ordered
    scenes, flattened as collate does."""
    rng = np.random.default_rng(seed)
    nbr3, down = [], []
    for b in range(n_samples):
        pts = rng.uniform(0, 2.5, size=(2500, 3))
        coords, _ = V.quantize(pts, pts.astype(np.float32), 0.05, raster_order=True)
        pyr = V.build_pyramid(coords, owner=0, num_stages=2, caps=[CAP0, CAP1], raster=True)
        st = V.pad_stage(pyr[1], CAP1, CAP0)
        nbr3.append(np.where(st.nbr3 >= 0, st.nbr3 + b * CAP1, -1))
        down.append(np.where(st.down >= 0, st.down + b * CAP0, -1))
    nbr3 = np.concatenate(nbr3).astype(np.int32)
    down = np.concatenate(down).astype(np.int32)
    up8 = V.build_up8(*V.invert_down(down, n_samples * CAP0))
    return {"subm": (nbr3, n_samples * CAP1), "down": (down, n_samples * CAP0), "up8": up8}


@pytest.fixture(scope="module")
def maps():
    return _maps(0)


def _bands(nbr, v_in):
    ws, wskt, dropped, total = V.compute_offset_window_starts(
        nbr, CHUNK, WINDOW, SUBWIN, v_in, count_drops=True)
    assert dropped == 0 and total == int((nbr >= 0).sum())
    return jnp.asarray(ws), jnp.asarray(wskt)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("cin,cout", [(64, 64), (32, 128)])
def test_k2_twin_matches_pallas(maps, cin, cout):
    nbr, v = maps["subm"]
    rng = np.random.default_rng(1)
    x, g = _randn(rng, v, cin), _randn(rng, v, cout)
    w = _randn(rng, 27, cin, cout, scale=1 / np.sqrt(27 * cin))
    ws, wskt = _bands(nbr, v)
    w_t = jnp.transpose(jnp.asarray(w)[::-1], (0, 2, 1))
    want_dx, want_dw = windowed_conv_bwd_fused(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(g), w_t, ws, wskt,
        window=WINDOW, chunk=CHUNK, subwin=SUBWIN, center_k=13, interpret=True)
    xt, nt, gt, wt = _t(x, nbr, g, w)
    dx, dw = sparse.subm_conv_bwd(xt, nt, gt, wt)
    assert dx.dtype == xt.dtype and dw.dtype == torch.float32  # dX in its input's dtype
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **DW_TOL)


@pytest.mark.parametrize("cin,cout", [(7, 32), (64, 64)])
@pytest.mark.parametrize("kind", ["subm", "down"])
def test_k3_twin_matches_pallas(maps, kind, cin, cout):
    nbr, v_in = maps[kind]
    rng = np.random.default_rng(2)
    x, g = _randn(rng, v_in, cin), _randn(rng, nbr.shape[0], cout)
    ws, wskt = _bands(nbr, v_in)
    want = np.asarray(windowed_conv_dw(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(g), ws, wskt,
        window=WINDOW, chunk=CHUNK, subwin=SUBWIN, interpret=True))[:, :cin, :cout]
    got = sparse.conv_dw(*_t(x, nbr, g))
    assert got.shape == (nbr.shape[1], cin, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DW_TOL)


def _grads(fn, *leaves, g):
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    fn(*leaves).backward(g)
    return [t.grad for t in leaves]


def test_subm_conv_grads_match_autograd_of_the_twin(maps):
    nbr, v = maps["subm"]
    nbr = np.concatenate([nbr, np.full((64, 27), -1, np.int32)])  # 64 padding rows
    v += 64
    rng = np.random.default_rng(3)
    x, w, g = _t(_randn(rng, v, 64), _randn(rng, 27, 64, 64, scale=0.03), _randn(rng, v, 64))
    tnbr = torch.from_numpy(nbr)
    got = _grads(lambda a, b: sparse_conv.subm_conv(a, tnbr, b), x, w, g=g)
    want = _grads(lambda a, b: sparse.gather_conv(a, tnbr, b), x, w, g=g)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **DW_TOL)
    # padding rows are nobody's neighbour: their dX is exactly 0
    pad = (nbr < 0).all(1)
    assert pad.any() and (got[0][torch.from_numpy(pad)] == 0).all()


def test_down_conv_grads_match_autograd_of_the_twin(maps):
    down, v_in = maps["down"]
    rng = np.random.default_rng(4)
    x, w = _t(_randn(rng, v_in, 32), _randn(rng, 8, 32, 64, scale=0.06))
    g = torch.from_numpy(_randn(rng, down.shape[0], 64))
    tdown, tup8 = torch.from_numpy(down), torch.from_numpy(maps["up8"])
    assert maps["up8"].max() < down.shape[0] and (maps["up8"] >= 0).sum() == (down >= 0).sum()
    got = _grads(lambda a, b: sparse_conv.down_conv(a, tdown, tup8, b), x, w, g=g)
    want = _grads(lambda a, b: sparse.gather_conv(a, tdown, b), x, w, g=g)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **DW_TOL)


def test_dw_only_backward_gives_zero_dx_and_the_same_dw(maps):
    nbr, v = maps["subm"]
    rng = np.random.default_rng(5)
    x, w, g = _t(_randn(rng, v, 64), _randn(rng, 27, 64, 32, scale=0.03), _randn(rng, v, 32))
    tnbr = torch.from_numpy(nbr)
    full = _grads(lambda a, b: sparse_conv.subm_conv(a, tnbr, b), x, w, g=g)
    stem = _grads(lambda a, b: sparse_conv.subm_conv(a, tnbr, b, grad_input=False), x, w, g=g)
    assert (stem[0] == 0).all() and full[0].abs().max() > 0
    torch.testing.assert_close(stem[1], full[1], rtol=1e-5, atol=1e-5)


@pytest.fixture
def bf16_policy():
    jprecision.set_compute_dtype("bfloat16")
    precision.set_compute_dtype("bfloat16")
    yield
    jprecision.set_compute_dtype(None)
    precision.set_compute_dtype(None)


def test_bf16_casts_match_banded_subm_conv_vjp(maps, bf16_policy):
    """dX comes back in bf16 and dW is rounded through bf16 before reaching
    the f32 parameter, on both sides."""
    nbr, v = maps["subm"]
    rng = np.random.default_rng(6)
    x, w = _randn(rng, v, 64), _randn(rng, 27, 64, 64, scale=0.03)
    g = np.asarray(jnp.asarray(_randn(rng, v, 64)).astype(jnp.bfloat16))
    ws, wskt = _bands(nbr, v)
    cast = jprecision.cast_in
    out, vjp = jax.vjp(lambda f, k: banded_subm_conv(
        cast(f), jnp.asarray(nbr), cast(k), ws, wskt, window=WINDOW, chunk=CHUNK,
        subwin=SUBWIN, interpret=True), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    assert out.dtype == jnp.bfloat16

    tg = torch.from_numpy(g.astype(np.float32)).bfloat16()
    xt, wt = _t(x, w)
    dx, dw = _grads(lambda a, b: sparse_conv.subm_conv(a, torch.from_numpy(nbr), b), xt, wt,
                    g=tg)
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype  # each in its input's dtype
    assert torch.equal(dw.bfloat16().float(), dw)  # rounded through bf16
    for got, want in ((dx, want_dx), (dw, want_dw)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2 * scale)


def test_cpu_backward_launches_no_kernel(maps):
    nbr, v = maps["subm"]
    down, v_in = maps["down"]
    before = (gather_conv.gather_conv.launches, conv_bwd.subm_conv_bwd.launches,
              conv_bwd.conv_dw.launches)
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(_randn(rng, v_in, 32))
    w0, w1 = (torch.from_numpy(_randn(rng, *s, scale=0.05)).requires_grad_(True)
              for s in ((8, 32, 64), (27, 64, 64)))
    h = sparse_conv.down_conv(x0, torch.from_numpy(down), torch.from_numpy(maps["up8"]), w0)
    sparse_conv.subm_conv(h, torch.from_numpy(nbr), w1).sum().backward()
    assert w0.grad.abs().max() > 0 and w1.grad.abs().max() > 0
    assert (gather_conv.gather_conv.launches, conv_bwd.subm_conv_bwd.launches,
            conv_bwd.conv_dw.launches) == before


@pytest.mark.parametrize("case", ["bf16", "bf16_strided", "f32_under_bf16", "f32_mode"])
def test_cotangent_is_cast_in_of_its_f32_and_copies_only_when_it_must(case):
    """``_cotangent(g)`` gives the bits of ``cast_in(g.float()).contiguous()``
    (the cast the JAX VJPs make); a bf16 contiguous cotangent comes back as
    itself (no copy, ``_cotangent.copies`` unchanged), a strided one or an
    f32 one under bf16 compute as one copy, counted under its Function."""
    base = torch.randn(40, 64, generator=torch.Generator().manual_seed(12))
    g = {"bf16": base.bfloat16(), "bf16_strided": base.bfloat16()[:, 16:48],
         "f32_under_bf16": base, "f32_mode": base}[case]
    precision.set_compute_dtype(None if case == "f32_mode" else "bfloat16")
    try:
        want = precision.cast_in(g.float()).contiguous()
        before, owned = sparse_conv._cotangent.copies, sparse_conv._cotangent.copied["Test"]
        got = sparse_conv._cotangent(g, "Test")
    finally:
        precision.set_compute_dtype(None)
    copied = case in ("bf16_strided", "f32_under_bf16")
    assert got.dtype == want.dtype and got.is_contiguous() and torch.equal(got, want)
    assert (got is not g) == copied and (got.data_ptr() == g.data_ptr()) == (not copied)
    assert sparse_conv._cotangent.copies == before + copied
    assert sparse_conv._cotangent.copied["Test"] == owned + copied


def _parent_grads(kind, x, w, g, nbr, up8, lists):
    """(dX, dW) by the backward formula before the compute dtype was kept
    end to end: the cotangent as ``cast_in(g.float())``, dX and dW summed
    in f32 by the twins, each then cast to its input's dtype."""
    gc = precision.cast_in(g.float()).contiguous()
    xc, wc = precision.cast_in(x).contiguous(), precision.cast_in(w).contiguous()
    if kind == "subm":
        dx, dw = sparse.subm_conv_bwd(xc, nbr, gc, wc)
    elif kind == "down":
        work_lists, counts = conv_bwd.list_view(lists, nbr.shape[0])
        dx = conv_bwd.down_dx_plain(gc, nbr, wc, work_lists, counts, x.shape[0])
        dw = sparse.conv_dw(xc, nbr, gc)
    else:
        dx = up_conv.up_dx_plain(gc, nbr, wc).to(gc.dtype)
        dw = up_conv.up_dw_plain(gc, nbr, xc)
    return dx.to(x.dtype), dw.to(w.dtype)


# (Function, Cin, Cout): a PointGroup pair and an InstanceRefer pair each
# (the inverse convs' Cin -> Cout mirror the downs')
BACKWARD_PAIRS = [("subm", 16, 16), ("subm", 64, 64), ("down", 16, 32), ("down", 32, 64),
                  ("inverse", 32, 16), ("inverse", 64, 32)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("kind, cin, cout", BACKWARD_PAIRS)
def test_bf16_backwards_give_the_bits_of_the_f32_round_trip(maps, kind, cin, cout, strided):
    """Under bf16 compute on the CPU twins, ``SubmConv``, ``DownConv`` and
    ``InverseConv`` give dX and dW bit-identical to the formula that took
    the cotangent through f32 and cast an f32 dX (``_parent_grads``), for a
    bf16 cotangent as it comes and for one strided as a concatenation's
    backward hands it on; the down conv for bf16 and f32 inputs."""
    rng = np.random.default_rng(cin * 100 + cout)
    nbr3, v = maps["subm"]
    down, v_in = maps["down"]
    up8, tdown = torch.from_numpy(maps["up8"]), torch.from_numpy(down)
    lists = conv_bwd.down_lists(tdown)
    k = 27 if kind == "subm" else 8
    v_x, v_g = {"subm": (v, v), "down": (v_in, down.shape[0]),
                "inverse": (down.shape[0], v_in)}[kind]
    x, w = _t(_randn(rng, v_x, cin), _randn(rng, k, cin, cout, scale=(k * cin) ** -0.5))
    wide = torch.from_numpy(_randn(rng, v_g, 2 * cout)).bfloat16()
    g = wide[:, cout:] if strided else wide[:, cout:].contiguous()
    nbr = {"subm": torch.from_numpy(nbr3), "down": tdown, "inverse": tdown}[kind]
    dtypes = (torch.bfloat16, torch.float32) if kind == "down" else (torch.bfloat16,)
    precision.set_compute_dtype("bfloat16")
    try:
        for dtype in dtypes:
            xl = x.to(dtype).requires_grad_(True)
            wl = (w.bfloat16() if kind == "subm" else w).requires_grad_(True)
            if kind == "subm":
                out = sparse_conv.SubmConv.apply(xl, nbr, wl, True)
            elif kind == "down":
                out = sparse_conv.down_conv(xl, nbr, up8, wl, lists)
            else:
                out = sparse_conv.inverse_conv(xl, nbr, up8, wl, lists)
            assert out.dtype == torch.bfloat16 and out.shape == g.shape
            got = torch.autograd.grad(out, (xl, wl), g)
            want = _parent_grads(kind, xl.detach(), wl.detach(), g, nbr, up8, lists)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (kind, dtype)
    finally:
        precision.set_compute_dtype(None)


def test_down_conv_keeps_an_f32_input_dx_unrounded(maps):
    """An f32 input to ``down_conv`` on the bf16 route: its dX is the f32
    of the sums, never rounded through bf16 (the list dX stores f32 for
    it), equal to the plain form's."""
    down, v_in = maps["down"]
    rng = np.random.default_rng(13)
    x, w = _t(_randn(rng, v_in, 32), _randn(rng, 8, 32, 64, scale=0.06))
    g = torch.from_numpy(_randn(rng, down.shape[0], 64)).bfloat16()
    tdown, up8 = torch.from_numpy(down), torch.from_numpy(maps["up8"])
    precision.set_compute_dtype("bfloat16")
    try:
        dx, = _grads(lambda a: sparse_conv.down_conv(a, tdown, up8, w), x, g=g)
    finally:
        precision.set_compute_dtype(None)
    lists, counts = conv_bwd.dw_lists_plain(tdown)
    want = conv_bwd.down_dx_plain(g, tdown, w.bfloat16(), lists, counts, v_in)
    assert dx.dtype == torch.float32 and torch.equal(dx, want)
    assert not torch.equal(dx.bfloat16().float(), dx)  # values bf16 cannot hold


@pytest.mark.parametrize("bad", ["g_dtype", "cout", "nbr_dtype", "weight", "even_k", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, g = torch.zeros(10, 64), torch.zeros(10, 64)
    nbr, w = torch.zeros(10, 27, dtype=torch.int32), torch.zeros(27, 64, 64)
    if bad == "g_dtype":
        g = g.double()
    elif bad == "cout":
        g, w = torch.zeros(10, 40), torch.zeros(27, 64, 40)
    elif bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "weight":
        w = torch.zeros(27, 32, 64)
    elif bad == "even_k":
        nbr, w = torch.zeros(10, 8, dtype=torch.int32), torch.zeros(8, 64, 64)
    else:  # neither CPU nor CUDA: no plain fallback
        x, g, nbr, w = (t.to("meta") for t in (x, g, nbr, w))
    with pytest.raises((TypeError, ValueError)):
        conv_bwd.subm_conv_bwd(x, nbr, g, w)
    if bad in ("g_dtype", "cout", "nbr_dtype", "device"):
        with pytest.raises((TypeError, ValueError)):
            conv_bwd.conv_dw(x, nbr, g)


def test_backward_imports_and_runs_without_nvcc():
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from instancerefer_tpu_torch.ops import conv_bwd as C\n"
        "nbr = torch.full((4, 27), -1, dtype=torch.int32); nbr[:, 13] = torch.arange(4, dtype=torch.int32)\n"
        "dx, dw = C.subm_conv_bwd(torch.ones(4, 32), nbr, torch.ones(4, 32), torch.ones(27, 32, 32))\n"
        "assert dx.shape == (4, 32) and dw.shape == (27, 32, 32) and float(dw[13, 0, 0]) == 4.0\n"
        "assert C.conv_dw(torch.ones(4, 7), nbr, torch.ones(4, 32)).shape == (27, 7, 32)\n"
        "assert C.subm_conv_bwd.launches == C.conv_dw.launches == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="", PYTHONPATH=ROOT, CUDA_HOME=os.devnull)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.gpu
def test_kernels_match_twins_on_card(maps):
    """Runs on a GPU only (the kernels have no CPU mode); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    nbr, v = maps["subm"]
    rng = np.random.default_rng(9)
    x, g, w = (torch.from_numpy(a).to(dev) for a in (
        _randn(rng, v, 64), _randn(rng, v, 64), _randn(rng, 27, 64, 64, scale=0.03)))
    tnbr = torch.from_numpy(nbr).to(dev)
    dx, dw = conv_bwd.subm_conv_bwd(x, tnbr, g, w)
    dw2 = conv_bwd.conv_dw(x, tnbr, g)
    torch.cuda.synchronize()
    rdx, rdw = sparse.subm_conv_bwd(x, tnbr, g, w)
    np.testing.assert_allclose(dx.cpu().numpy(), rdx.cpu().numpy(), **TOL)
    np.testing.assert_allclose(dw.cpu().numpy(), rdw.cpu().numpy(), **DW_TOL)
    np.testing.assert_allclose(dw2.cpu().numpy(), sparse.conv_dw(x, tnbr, g).cpu().numpy(),
                               **DW_TOL)
