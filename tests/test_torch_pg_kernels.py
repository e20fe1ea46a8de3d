"""The sparse-conv kernels at the widths of PointGroup's U-Net (m = 16):
K1, K2, K3 and the downs' dX at every (Cin, Cout) pair the U-Net adds
(``gather_conv.PG_SUBM_PAIRS``, ``PG_DOWN_PAIRS``), the inverse convs'
kernels (``ops/up_conv``), and the stem kernels at Cout 16 (the input
conv, 6 -> 16), each against its plain twin.

On the CPU: the pair lists and the warp split of the dW kernels as the
CUDA sources have them, and the inverse conv's plain forms against the
conv's definition.  On the card (``@pytest.mark.gpu``, skipped without
one; no JAX is imported, so ``python -m pytest tests/test_torch_pg_kernels.py
-m gpu --noconftest`` runs them there): every pair against the twin on a
random map with empty rows and offsets, a second launch bit-identical,
the rows no entry names 0, and the host's shared-memory sizes equal to the
libraries'.  The twins sum the same bf16 inputs in f32 in another order:
f32 outputs within 1e-4 of the largest value, bf16 outputs within 1e-2
(one rounding).
"""

import ctypes
import os
import re

import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse, up_conv
from instancerefer_tpu_torch.ops import gather_conv as G

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _macro_pairs(name):
    with open(os.path.join(ROOT, "instancerefer_tpu_torch", "csrc", "sparse_conv_tc.cuh")) as f:
        text = f.read()
    body = re.search(rf"#define {name}\(X\)(.*?)\n(?!\s)", text, re.S).group(1)
    return tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body))


def test_pair_lists_are_the_sources():
    assert _macro_pairs("IRSC_IR_PAIRS") == G.IR_PAIRS
    assert _macro_pairs("IRSC_PG_SUBM_PAIRS") == G.PG_SUBM_PAIRS
    assert _macro_pairs("IRSC_PG_DOWN_PAIRS") == G.PG_DOWN_PAIRS


def test_pointgroup_pairs_cover_the_unet():
    """Every conv of the U-Net at m = 16 has its kernels: c -> c and 2c ->
    c submanifold convs (K1, K2), c -> c + 16 downs (K1, K3, the list dX)."""
    widths = [16 * i for i in range(1, 8)]
    for c in widths:
        assert (c, c) in G.K1_PAIRS[torch.bfloat16] and (c, c) in G.K2_PAIRS
    for c in widths[:-1]:
        assert (2 * c, c) in G.K1_PAIRS[torch.bfloat16] and (2 * c, c) in G.K2_PAIRS
        assert (c, c + 16) in G.K1_PAIRS[torch.bfloat16] and (c, c + 16) in G.K3_PAIRS
    assert G.route(torch.bfloat16, 6, "cuda") == "stem_wide"
    assert all(G.route(torch.bfloat16, c, "cuda") == "tensor_core" for c in widths)


@pytest.mark.parametrize("cin, cout", G.IR_PAIRS)
def test_warp_split_keeps_instancerefer_widths(cin, cout):
    """At {32, 64, 128} the split is the one the kernels had: WM = min(Cin /
    16, 4), WN = min(Cout / 16, 8 / WM), two offsets a block."""
    wm = min(cin // 16, 4)
    assert conv_bwd.warp_split(cin, cout, 2) == (wm, min(cout // 16, 8 // wm), 2)
    assert conv_bwd.warp_split(cin, cout, 1)[:2] == (wm, min(cout // 16, 8 // wm))


@pytest.mark.parametrize("cin, cout", G.K2_PAIRS + G.PG_DOWN_PAIRS)
def test_warp_split_covers_the_product(cin, cout):
    wm, wn, g = conv_bwd.warp_split(cin, cout, 2)
    mt, nt = cin // 16 // wm, cout // 8 // wn
    assert wm * mt * 16 == cin and wn * nt * 8 == cout and nt % 2 == 0
    assert wm * wn <= 8 and g * mt * nt * 4 <= 128 and g >= 1


def _down(gen, v_out, v_in, fill=0.7):
    n = min(int(fill * v_in), v_out * 8)
    slots = torch.randperm(v_out * 8, generator=gen)[:n]
    rows = torch.randperm(v_in, generator=gen)[:n].int()
    down = torch.full((v_out * 8,), -1, dtype=torch.int32)
    down[slots] = rows
    up8 = torch.full((v_in, 8), -1, dtype=torch.int32)
    up8[rows.long(), slots % 8] = (slots // 8).int()
    return down.view(v_out, 8), up8


def test_inverse_conv_plain_forms_follow_the_definition():
    """``up_conv_plain``: each fine row its parent's row times its offset's
    slice, 0 without a parent; ``up_dx_plain`` and ``up_dw_plain``: the
    gradients autograd gives that definition."""
    gen = torch.Generator().manual_seed(3)
    down, up8 = _down(gen, 40, 200)
    x = torch.randn(40, 48, generator=gen, requires_grad=True)
    w = torch.randn(8, 48, 32, generator=gen, requires_grad=True)
    rows = [(int(down[v, k]), v, k) for v in range(40) for k in range(8) if down[v, k] >= 0]
    want = torch.zeros(200, 32)
    for u, v, k in rows:
        want[u] = x[v].detach() @ w[k].detach()
    got = up_conv.up_conv_plain(x, down, w, 200)
    assert torch.allclose(got, want, atol=1e-5)
    gy = torch.randn(200, 32, generator=gen)
    fine = torch.stack([x[up8[u][up8[u] >= 0][0].long()] @ w[int((up8[u] >= 0).nonzero()[0])]
                        if (up8[u] >= 0).any() else torch.zeros(32) for u in range(200)])
    dx, dw = torch.autograd.grad(fine, (x, w), gy)
    assert torch.allclose(up_conv.up_dx_plain(gy, down, w.detach()), dx, atol=1e-4)
    assert torch.allclose(up_conv.up_dw_plain(gy, down, x.detach()), dw, atol=1e-4)


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol, what=""):
    got, want = got.float().cpu(), want.float().cpu()
    top = want.abs().max().item() if want.numel() else 0.0
    err = (got - want).abs().max().item() if got.numel() else 0.0
    assert err <= tol * max(top, 1e-6), f"{what}: max |err| {err:.3e}, max |want| {top:.3e}"


def _nbr3(gen, v, fill=0.4):
    """A random 27-offset map over v rows, symmetric as the host maps are
    (offset 26 - k mirrors k), the centre the row itself, the first 100
    rows empty (padding)."""
    nbr = torch.full((v, 27), -1, dtype=torch.int32)
    nbr[:, 13] = torch.arange(v, dtype=torch.int32)
    for k in range(13):
        pick = torch.rand(v, generator=gen) < fill
        other = torch.randint(0, v, (v,), generator=gen, dtype=torch.int32)
        src = torch.nonzero(pick)[:, 0]
        nbr[src, k] = other[src]
        nbr[other[src].long(), 26 - k] = src.int()
    nbr[:100] = -1
    nbr[torch.isin(nbr, torch.arange(100, dtype=torch.int32))] = -1
    return nbr


def _bf(gen, *shape):
    return torch.randn(*shape, generator=gen).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", G.PG_SUBM_PAIRS + G.PG_DOWN_PAIRS)
def test_k1_at_pointgroup_pairs_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator().manual_seed(cin * 1000 + cout)
    for k, v_out, v_in in ((27, 9000, 9000), (8, 3001, 11000), (27, 130, 130)):
        nbr = _nbr3(gen, v_out) if k == 27 else _down(gen, v_out, v_in)[0]
        x, w = _bf(gen, v_in, cin), _bf(gen, k, cin, cout)
        want = sparse.gather_conv(x, nbr, w)
        got = G.gather_conv(x.to(dev), nbr.to(dev), w.to(dev))
        again = G.gather_conv(x.to(dev), nbr.to(dev), w.to(dev))
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        _close(got, want, TOL[torch.bfloat16], f"K1 {cin}->{cout} K={k}")


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", G.PG_SUBM_PAIRS)
def test_k2_at_pointgroup_pairs_on_card(cin, cout):
    dev = _card()
    gen = torch.Generator().manual_seed(cin * 1000 + cout + 1)
    for v in (12000, 150):
        nbr = _nbr3(gen, v)
        x, g, w = _bf(gen, v, cin), _bf(gen, v, cout), _bf(gen, 27, cin, cout)
        want = sparse.subm_conv_bwd(x, nbr, g, w)
        got = conv_bwd.subm_conv_bwd(x.to(dev), nbr.to(dev), g.to(dev), w.to(dev))
        again = conv_bwd.subm_conv_bwd(x.to(dev), nbr.to(dev), g.to(dev), w.to(dev))
        for name, a, b, c in zip(("dX", "dW"), got, again, want):
            assert torch.equal(a, b), f"K2 {name} {cin}->{cout}: a second launch differs"
            _close(a, c, TOL[torch.float32], f"K2 {name} {cin}->{cout}")


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", G.PG_DOWN_PAIRS)
def test_down_and_inverse_kernels_at_pointgroup_pairs_on_card(cin, cout):
    """The down's K3 and dX over its lists, and the inverse conv (cout ->
    cin) forward, dX and dW over the same lists, against their plain forms;
    a map with an empty offset and empty rows, and a map of one row."""
    dev = _card()
    gen = torch.Generator().manual_seed(cin * 1000 + cout + 2)
    for v_out, v_in in ((5000, 30000), (1, 8)):
        down, up8 = _down(gen, v_out, v_in)
        if v_out > 200:
            up8[down[:, 5][down[:, 5] >= 0].long()] = -1
            down[:, 5] = -1
        dd, uu = down.to(dev), up8.to(dev)
        work = conv_bwd.down_lists(dd)
        lists, counts = conv_bwd.dw_lists_plain(down)
        x, g, w = _bf(gen, v_in, cin), _bf(gen, v_out, cout), _bf(gen, 8, cin, cout)
        _close(conv_bwd.conv_dw(x.to(dev), dd, g.to(dev), lists=work),
               sparse.conv_dw(x, down, g), TOL[torch.float32], "K3")
        dx = conv_bwd.down_dx(g.to(dev), dd, uu, w.to(dev), work)
        _close(dx, conv_bwd.down_dx_plain(g, down, w, lists, counts, v_in),
               TOL[torch.float32], "down dX")
        # the inverse conv of the same map: coarse rows of Cout channels -> fine rows of Cin
        wi, xc, gf = _bf(gen, 8, cout, cin), _bf(gen, v_out, cout), _bf(gen, v_in, cin)
        before = up_conv.up_conv.launches
        out = up_conv.up_conv(xc.to(dev), dd, uu, wi.to(dev), work)
        again = up_conv.up_conv(xc.to(dev), dd, uu, wi.to(dev), work)
        assert out.dtype == torch.bfloat16 and torch.equal(out, again)
        _close(out, up_conv.up_conv_plain(xc, down, wi, v_in), TOL[torch.bfloat16], "up")
        assert not out[(up8 < 0).all(1).to(dev)].any()
        udx = up_conv.up_dx(gf.to(dev), dd, wi.to(dev))
        _close(udx, up_conv.up_dx_plain(gf, down, wi), TOL[torch.bfloat16], "up dX")
        udw = up_conv.up_dw(gf.to(dev), dd, xc.to(dev), work)
        assert torch.equal(udw, up_conv.up_dw(gf.to(dev), dd, xc.to(dev), work))
        _close(udw, up_conv.up_dw_plain(gf, down, xc), TOL[torch.float32], "up dW")
        assert up_conv.up_conv.launches == before + 5


@pytest.mark.gpu
def test_stem_at_cout_16_on_card():
    """PointGroup's input conv, 6 -> 16 over 27 offsets: the stem kernels
    with blocks of 16 columns, K1 and K3 against the twins."""
    dev = _card()
    gen = torch.Generator().manual_seed(616)
    nbr = _nbr3(gen, 20000)
    x, w, g = _bf(gen, 20000, 6), _bf(gen, 27, 6, 16), _bf(gen, 20000, 16)
    xp = G.pad_channels(x.to(dev))
    _close(G.gather_conv(xp, nbr.to(dev), w.to(dev)), sparse.gather_conv(x, nbr, w),
           TOL[torch.bfloat16], "stem K1")
    _close(conv_bwd.conv_dw(xp, nbr.to(dev), g.to(dev), cin=6), sparse.conv_dw(x, nbr, g),
           TOL[torch.float32], "stem K3")


@pytest.mark.gpu
def test_smem_sizes_match_the_build_on_card():
    _card()

    def entry(lib, name):
        fn = getattr(G.library(lib), name)
        fn.restype = ctypes.c_longlong
        return fn

    tc = entry("gather_conv", "ir_tc_smem_bytes")
    for cin, cout in G.K1_PAIRS[torch.bfloat16]:
        assert tc(cin, cout, 0, 27) == G.tc_smem_bytes(27, cin, cout)
    for cin, cout in G.K2_PAIRS:
        assert tc(cout, cin, 1, 27) == G.tc_smem_bytes(27, cout, cin, mirror=True)
        assert entry("subm_conv_bwd", "ir_dw_group_smem_bytes")(cin, cout) == \
            conv_bwd.dw_group_smem_bytes(cin, cout)
    for cin, cout in G.K3_PAIRS:
        assert entry("conv_dw", "ir_dw_list_smem_bytes")(cin, cout) == \
            conv_bwd.dw_list_smem_bytes(cin, cout)
        assert entry("gather_conv", "ir_dx_list_smem_bytes")(cin, cout) == \
            conv_bwd.dx_list_smem_bytes(cin, cout)
