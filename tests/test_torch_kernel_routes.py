"""Which path a sparse-conv call takes, the stem kernels' layout, and the
tensor-core and stem kernels against their plain twins on the card.

``ops/gather_conv.route`` decides from the device, the input type and Cin
alone: the plain twin on the CPU; on a card, for bf16, the tensor-core
kernels at Cin in {32, 64, 128} (K1's down, residual and ``up8`` calls, K2,
and K3 at the downs) and the stem kernels at any other Cin (K1 and K3 at
the stems: 7 channels, 10 with normals, 135 with multiview features); the
FMA kernels for f32.  The stem kernels take their depth from the im2col of
a row, each neighbour's channels padded to ``stem_channels`` (16 bytes);
``stem_im2col``/``stem_weight``/``stem_dw`` write that layout in PyTorch
and are held here against the plain twins (f32, sums in another order:
1e-5).

The card tests (``@pytest.mark.gpu``) skip without a CUDA device.  This file
imports no JAX, so on a card it also runs without the repo's conftest:
``python -m pytest tests/test_torch_kernel_routes.py -m gpu --noconftest``.
Tolerances as in ``chip_smoke.py``: bf16 outputs within 1e-2 of the largest
value (one bf16 ulp where two f32 sums round apart); f32 outputs (K1's f32
output, K2's dX) within 1e-5 and dW within 1e-4 of the largest value.
"""

import itertools

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse
from instancerefer_tpu_torch.ops import gather_conv as G

WIDTHS = (32, 64, 128)


@pytest.mark.parametrize("dtype, cin, device, want", [
    (torch.bfloat16, 64, "cpu", "twin"),
    (torch.float32, 64, "cpu", "twin"),
    (torch.bfloat16, 7, "cpu", "twin"),
    (torch.bfloat16, 32, "cuda", "tensor_core"),
    (torch.bfloat16, 128, "cuda", "tensor_core"),
    (torch.bfloat16, 64, "cuda", "tensor_core"),
    (torch.bfloat16, 16, "cuda", "stem_wide"),
    (torch.bfloat16, 15, "cuda", "stem_wide"),
    (torch.bfloat16, 9, "cuda", "stem_wide"),
    (torch.bfloat16, 8, "cuda", "stem_wide"),
    (torch.bfloat16, 7, "cuda", "stem_wide"),
    (torch.bfloat16, 3, "cuda", "stem_wide"),
    (torch.bfloat16, 10, "cuda", "stem_wide"),
    (torch.bfloat16, 135, "cuda", "stem_wide"),
    (torch.bfloat16, 200, "cuda", "stem_wide"),
    (torch.bfloat16, 48, "cuda", "stem_wide"),
    (torch.float32, 128, "cuda", "fma"),
    (torch.float32, 7, "cuda", "fma"),
    (torch.float32, 135, "cuda", "fma"),
])
def test_route_from_device_dtype_and_cin(dtype, cin, device, want):
    assert G.route(dtype, cin, device) == want
    assert G.route(dtype, cin, torch.device(device)) == want


def test_tensor_core_path_checks_widths_and_alignment():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    G.check_tc("k", (64, 128), x)
    for widths in ((48, 64), (64, 16), (256, 64)):
        with pytest.raises(ValueError, match="widths"):
            G.check_tc("k", widths, x)
    with pytest.raises(ValueError, match="aligned"):
        G.check_tc("k", (64, 64), x.view(-1)[1:65].view(1, 64))


@pytest.mark.parametrize("cin", [7, 32, 64, 10, 135])
def test_cpu_calls_take_the_twin_and_launch_nothing(cin):
    """bf16 on the CPU: the twin, for every Cin, no kernel launched; at the
    wide stems' widths also from rows padded by ``pad_channels``."""
    nbr = torch.randint(-1, 10, (12, 27), dtype=torch.int32)
    x = torch.randn(10, cin).bfloat16()
    w = torch.randn(27, cin, 32).bfloat16()
    g = torch.randn(12, 32).bfloat16()
    counters = (G.gather_conv, conv_bwd.subm_conv_bwd, conv_bwd.conv_dw)
    before = [f.launches for f in counters] + [G.gather_conv.stem_launches,
                                               conv_bwd.conv_dw.stem_launches]
    assert torch.equal(G.gather_conv(x, nbr, w), sparse.gather_conv(x, nbr, w))
    assert torch.equal(conv_bwd.conv_dw(x, nbr, g), sparse.conv_dw(x, nbr, g))
    if cin in WIDTHS:
        g = torch.randn(10, 32).bfloat16()
        nbr = torch.randint(-1, 10, (10, 27), dtype=torch.int32)
        got, want = conv_bwd.subm_conv_bwd(x, nbr, g, w), sparse.subm_conv_bwd(x, nbr, g, w)
        assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(got, want))
    elif G.stem_channels(cin) != cin:
        xp = G.pad_channels(x)
        assert xp.shape == (10, G.stem_channels(cin)) and not xp[:, cin:].any()
        assert torch.equal(G.gather_conv(xp, nbr, w), sparse.gather_conv(x, nbr, w))
        assert torch.equal(conv_bwd.conv_dw(xp, nbr, g, cin=cin), sparse.conv_dw(x, nbr, g))
    assert [f.launches for f in counters] + [G.gather_conv.stem_launches,
                                             conv_bwd.conv_dw.stem_launches] == before


@pytest.mark.parametrize("cin", [7, 3, 8, 9, 10, 17, 135])
def test_stem_layout_matches_the_twins(cin):
    """im2col of the rows times the flattened weight is the conv, and its
    transpose times g is dW: row k * cp + c is dW[k, c] in the stored
    [27, Cin, Cout] layout, and the rows of padding channels and depth are
    zero and never reach dW.  cp = Cin rounded up to 8."""
    rng = np.random.default_rng(cin)
    v_in, v_out = 300, 200
    cp = G.stem_channels(cin)
    width = 27 * cp
    nbr = rng.integers(0, v_in, size=(v_out, 27)).astype(np.int32)
    nbr[rng.random(nbr.shape) >= 0.4] = -1
    nbr[100:164] = -1  # a tile of padding rows
    x, w, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((v_in, cin), (27, cin, 32), (v_out, 32)))
    nbr = torch.from_numpy(nbr)
    assert cp == -(-cin // 8) * 8
    cols, wf = G.stem_im2col(x, nbr), G.stem_weight(w)
    depth = G.stem_depth(cin)
    assert depth % 16 == 0 and width <= depth < width + 16 and G.stem_depth(7) == 224
    assert G.stem_depth(135) == 3680 and G.stem_depth(10) == 432
    assert cols.shape == (v_out, depth) and wf.shape == (depth, 32)
    assert not cols[:, width:].any() and not wf[width:].any() and not cols[100:164].any()
    pad = torch.arange(depth) % cp >= cin  # columns of padding channels
    assert not cols[:, pad[:width].nonzero().flatten()].any() and not wf[:width][pad[:width]].any()
    v, k = 5, 11  # column k * cp + c holds channel c of neighbour k
    want = x[nbr[v, k]] if nbr[v, k] >= 0 else torch.zeros(cin)
    assert torch.equal(cols[v, k * cp:k * cp + cin], want)
    assert torch.equal(wf[k * cp:k * cp + cin], w[k])
    # f32 sums of 27 * Cin products in another order: the rounding grows
    # with the depth past the 8-channel stems
    atol = 1e-5 * max(1.0, cin / 8)
    torch.testing.assert_close(cols @ wf, sparse.gather_conv(x, nbr, w), rtol=1e-5, atol=atol)
    product = cols.T @ g
    assert not product[width:].any() and not product[:width][pad[:width]].any()
    dw = G.stem_dw(product, cin)
    assert dw.shape == (27, cin, 32)
    torch.testing.assert_close(dw, sparse.conv_dw(x, nbr, g), rtol=1e-5, atol=atol)


def _fake_entries(monkeypatch, module, path):
    """Route every call of ``module``'s wrapper to ``path`` and record the
    C entry it would launch instead of launching it."""
    calls = []

    def entry(*key):
        name = next(k for k in key if str(k).startswith("ir_"))

        def launch(*args):
            calls.append((name, len(args)))
            return 0
        return launch

    monkeypatch.setattr(module, "route", lambda dtype, cin, device: path)
    monkeypatch.setattr(module, "_entry", entry)
    monkeypatch.setattr(module, "cuda_stream", lambda t: 0)
    if hasattr(module, "sm_count"):
        monkeypatch.setattr(module, "sm_count", lambda device: 132)  # an H100's
    return calls


@pytest.mark.parametrize("path, cin, k, entry, n_args", [
    ("twin", 7, 27, None, 0),
    ("fma", 7, 27, "ir_conv_dw", 12),
    ("tensor_core", 32, 8, "ir_conv_dw_tc", 11),
    ("stem_wide", 7, 27, "ir_conv_dw_stem_wide", 11),
    ("stem_wide", 10, 27, "ir_conv_dw_stem_wide", 11),
    ("stem_wide", 135, 27, "ir_conv_dw_stem_wide", 11),
])
def test_conv_dw_follows_route(monkeypatch, path, cin, k, entry, n_args):
    """K3's wrapper launches the entry of the route it is given (one launch
    counted) and runs the twin only on the route ``"twin"``."""
    calls = _fake_entries(monkeypatch, conv_bwd, path)
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(40, cin, generator=gen).bfloat16()
    nbr = torch.randint(-1, 40, (50, k), generator=gen, dtype=torch.int32)
    g = torch.randn(50, 32, generator=gen).bfloat16()
    before = conv_bwd.conv_dw.launches
    out = conv_bwd.conv_dw(x, nbr, g)
    assert out.shape == (k, cin, 32) and out.dtype == torch.float32
    if entry is None:
        assert calls == [] and conv_bwd.conv_dw.launches == before
        assert torch.equal(out, sparse.conv_dw(x, nbr, g))
    else:
        assert calls == [(entry, n_args)] and conv_bwd.conv_dw.launches == before + 1


@pytest.mark.parametrize("path, cin, k, entry", [
    ("fma", 7, 27, "ir_gather_conv"),
    ("tensor_core", 32, 8, "ir_gather_conv_tc"),
    ("stem_wide", 7, 27, "ir_gather_conv_stem_wide"),
    ("stem_wide", 10, 27, "ir_gather_conv_stem_wide"),
    ("stem_wide", 135, 27, "ir_gather_conv_stem_wide"),
])
def test_gather_conv_follows_route(monkeypatch, path, cin, k, entry):
    calls = _fake_entries(monkeypatch, G, path)
    x = torch.zeros(40, cin, dtype=torch.bfloat16)
    before = G.gather_conv.launches
    out = G.gather_conv(x, torch.zeros(50, k, dtype=torch.int32),
                        torch.zeros(k, cin, 32, dtype=torch.bfloat16))
    assert out.shape == (50, 32) and G.gather_conv.launches == before + 1
    assert [name for name, _ in calls] == [entry]


@pytest.mark.parametrize("path, cin", [("stem_wide", 7), ("stem_wide", 10)])
def test_stem_route_refuses_other_maps(monkeypatch, path, cin):
    """The stem kernels are built for the 27-offset map only: another K on
    that route raises, with no fallback to another kernel."""
    for module in (G, conv_bwd):
        _fake_entries(monkeypatch, module, path)
    x = torch.zeros(40, cin, dtype=torch.bfloat16)
    nbr = torch.zeros(50, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="K = 27"):
        G.gather_conv(x, nbr, torch.zeros(8, cin, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="K = 27"):
        conv_bwd.conv_dw(x, nbr, torch.zeros(50, 32, dtype=torch.bfloat16))


def test_padded_rows_only_where_the_route_reads_them(monkeypatch):
    """Rows padded to 16 bytes go to the stem kernels (as they are) and to
    the twin (through a view); the other routes, and a width that is
    neither Cin nor its padding, raise."""
    calls = _fake_entries(monkeypatch, G, "stem_wide")
    w = torch.zeros(27, 10, 32, dtype=torch.bfloat16)
    nbr = torch.zeros(50, 27, dtype=torch.int32)
    G.gather_conv(torch.zeros(40, 16, dtype=torch.bfloat16), nbr, w)
    assert [name for name, _ in calls] == ["ir_gather_conv_stem_wide"]
    for path in ("tensor_core", "fma"):
        monkeypatch.setattr(G, "route", lambda dtype, cin, device, p=path: p)
        with pytest.raises(ValueError, match="channels"):
            G.gather_conv(torch.zeros(40, 16, dtype=torch.bfloat16), nbr, w)
    with pytest.raises(ValueError, match="disagree"):
        G.gather_conv(torch.zeros(40, 12, dtype=torch.bfloat16), nbr, w)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _map(gen, v_out, v_in, k, dev):
    """Random indices, 40% valid, with two whole 64-row tiles and parts of
    two more all padding, one offset empty in one tile and one offset empty
    everywhere."""
    nbr = torch.randint(0, v_in, (v_out, k), generator=gen, device=dev, dtype=torch.int32)
    nbr[torch.rand(v_out, k, generator=gen, device=dev) >= 0.4] = -1
    nbr[64:200] = -1
    nbr[300:400, 3] = -1
    nbr[:, 5] = -1
    return nbr.contiguous()


def _close(got, ref, tol):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(WIDTHS, WIDTHS)))
def test_tensor_core_k1_matches_twin_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    nbr = _map(gen, 1000, 900, 27, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    sc = 0.5 + torch.rand(cout, device=dev, generator=gen)
    bi = 0.1 * torch.randn(cout, device=dev, generator=gen)
    assert G.route(x.dtype, cin, x.device) == "tensor_core"
    before = G.gather_conv.launches
    got = G.gather_conv(x, nbr, w, sc, bi, relu=True)
    assert G.gather_conv.launches == before + 1
    _close(got, sparse.gather_conv(x, nbr, w, sc, bi, relu=True), 1e-2)
    assert torch.equal(got[64:192].float(), torch.relu(bi).bfloat16().float().expand(128, cout))
    # the down conv's dX over up8: one valid neighbour a row, f32 output
    up8 = torch.full((1000, 8), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(1000, device=dev)
    up8[rows, rows % 8] = torch.randint(0, 900, (1000,), generator=gen, device=dev,
                                        dtype=torch.int32)
    w8 = w[:8].contiguous()
    got = G.gather_conv(x, up8, w8, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, sparse.gather_conv(x, up8, w8, out_dtype=torch.float32), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(WIDTHS, WIDTHS)))
def test_tensor_core_k2_matches_twin_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout)
    nbr = _map(gen, 1000, 1000, 27, dev)
    x = torch.randn(1000, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(1000, cout, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    dx, dw = conv_bwd.subm_conv_bwd(x, nbr, g, w)
    ref_dx, ref_dw = sparse.subm_conv_bwd(x, nbr, g, w)
    _close(dx, ref_dx, 1e-5)
    _close(dw, ref_dw, 1e-4)
    assert torch.equal(dx[64:200], torch.zeros_like(dx[64:200]))
    assert torch.equal(dw, conv_bwd.subm_conv_bwd(x, nbr, g, w)[1])  # bit-identical


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(WIDTHS, (64, 128))))
def test_tensor_core_k3_matches_twin_on_card(cin, cout):
    """K3 at a down conv's shape (K = 8): 1000 rows (not a multiple of the
    64-row tile), padding tiles, an offset empty everywhere."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin + 3 * cout)
    nbr = _map(gen, 1000, 900, 8, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(1000, cout, device=dev, generator=gen).bfloat16()
    assert G.route(x.dtype, cin, x.device) == "tensor_core"
    before = conv_bwd.conv_dw.launches
    dw = conv_bwd.conv_dw(x, nbr, g)
    assert conv_bwd.conv_dw.launches == before + 1
    _close(dw, sparse.conv_dw(x, nbr, g), 1e-4)
    assert torch.equal(dw[5], torch.zeros_like(dw[5]))
    assert torch.equal(dw, conv_bwd.conv_dw(x, nbr, g))  # bit-identical


def _stem_map(gen, v_out, v_in, dev):
    """``_map`` at K = 27, and, where the rows reach them, two whole
    128-row tiles of padding rows (the stem K1's tile) and a run of tiles
    with no valid index in a split of the stem K3."""
    nbr = _map(gen, v_out, v_in, 27, dev)
    nbr[512:768] = -1
    nbr[20000:30000] = -1
    return nbr


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("cin, cout, v_out", [
    (7, 32, 1000), (7, 64, 1000), (3, 32, 1000), (8, 128, 1000), (9, 32, 1000),
    (10, 32, 1000), (10, 32, 40000), (17, 32, 1000), (135, 32, 1000), (135, 32, 40000),
    (135, 128, 1000), (200, 32, 1000), (48, 64, 1000)])
def test_stem_k1_matches_twin_on_card(cin, cout, v_out, epilogue):
    """K1's stem route at K = 27: bf16 out with and without the epilogue,
    f32 out, padding tiles storing their epilogue of a zero sum; rows padded
    to 16 bytes, the depth in stages of 64 columns (4 at Cin 3 and 7, 7 at
    10, 58 at 135, 85 at 200), from
    [V, Cin] rows (the wrapper pads them) and from ``pad_channels``' rows
    (as the stems' input comes); 1000 rows end in a ragged tile."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout + epilogue + v_out)
    nbr = _stem_map(gen, v_out, 900, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    sc = 0.5 + torch.rand(cout, device=dev, generator=gen) if epilogue else None
    bi = 0.1 * torch.randn(cout, device=dev, generator=gen) if epilogue else None
    assert G.route(x.dtype, cin, x.device) == "stem_wide"
    before = (G.gather_conv.launches, G.gather_conv.stem_launches)
    got = G.gather_conv(x, nbr, w, sc, bi, relu=epilogue)
    assert (G.gather_conv.launches, G.gather_conv.stem_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    _close(got, sparse.gather_conv(x, nbr, w, sc, bi, relu=epilogue), 1e-2)
    pad = torch.relu(bi).bfloat16().float() if epilogue else torch.zeros(cout, device=dev)
    assert torch.equal(got[64:192].float(), pad.expand(128, cout))
    if v_out > 768:
        assert torch.equal(got[512:768].float(), pad.expand(256, cout))
    if G.stem_channels(cin) != cin:
        assert torch.equal(G.gather_conv(G.pad_channels(x), nbr, w, sc, bi, relu=epilogue), got)
    got = G.gather_conv(x, nbr, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, G.stem_im2col(x, nbr) @ G.stem_weight(w), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout, v_out", [(7, 32, 1000), (7, 32, 40000), (7, 64, 1000),
                                              (8, 32, 1000), (3, 128, 1000), (9, 32, 1000),
                                              (10, 32, 1000), (10, 32, 40000), (17, 32, 1000),
                                              (135, 32, 1000), (135, 32, 40000),
                                              (135, 64, 1000), (200, 32, 1000),
                                              (200, 32, 40000)])
def test_stem_k3_matches_twin_on_card(cin, cout, v_out):
    """K3's stem route at K = 27: the depth's blocks of 768 columns on the
    grid, one pass over g and the map for all offsets in each (1 block at
    Cin <= 28, 5 at 135, 8 at 200), dW [27, Cin, Cout] with no
    padding rows; 40000 rows give each split more than one tile, 1000 rows
    leave splits empty; dW is bit-identical across launches."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout + v_out)
    nbr = _stem_map(gen, v_out, 900, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(v_out, cout, device=dev, generator=gen).bfloat16()
    assert G.route(x.dtype, cin, x.device) == "stem_wide"
    before = (conv_bwd.conv_dw.launches, conv_bwd.conv_dw.stem_launches)
    dw = conv_bwd.conv_dw(x, nbr, g)
    assert (conv_bwd.conv_dw.launches, conv_bwd.conv_dw.stem_launches) == \
        (before[0] + 1, before[1] + 1)
    assert dw.shape == (27, cin, cout)
    ref = sparse.conv_dw(x, nbr, g)
    _close(dw, ref, 1e-4)
    assert torch.equal(dw[5], torch.zeros_like(dw[5]))
    _close(dw, G.stem_dw(G.stem_im2col(x, nbr).T @ g.float(), cin), 1e-4)
    assert torch.equal(dw, conv_bwd.conv_dw(x, nbr, g))  # bit-identical
    if G.stem_channels(cin) != cin:
        assert torch.equal(conv_bwd.conv_dw(G.pad_channels(x), nbr, g, cin=cin), dw)


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [10, 135])
def test_fma_k1_and_k3_beyond_the_stem_widths_on_card(cin):
    """f32 at the stems' other widths: K1's FMA kernel loops over Cin in
    tiles of 32, K3's puts Cin tiles of 128 on its grid (two at 135)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin)
    nbr = _map(gen, 1000, 900, 27, dev)
    x = torch.randn(900, cin, device=dev, generator=gen)
    w = torch.randn(27, cin, 32, device=dev, generator=gen) / (27 * cin) ** 0.5
    g = torch.randn(1000, 32, device=dev, generator=gen)
    assert G.route(x.dtype, cin, x.device) == "fma"
    _close(G.gather_conv(x, nbr, w), sparse.gather_conv(x, nbr, w), 1e-5)
    dw = conv_bwd.conv_dw(x, nbr, g)
    _close(dw, sparse.conv_dw(x, nbr, g), 1e-4)
    assert torch.equal(dw, conv_bwd.conv_dw(x, nbr, g))  # bit-identical


@pytest.mark.gpu
def test_tensor_core_path_refuses_what_it_cannot_take():
    """A row the 16-byte copies cannot read: x one element off alignment."""
    dev = _card()
    nbr = torch.zeros(4, 27, dtype=torch.int32, device=dev)
    x = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(4, 64)
    with pytest.raises(ValueError, match="aligned"):
        G.gather_conv(x, nbr, torch.zeros(27, 64, 32, dtype=torch.bfloat16, device=dev))
