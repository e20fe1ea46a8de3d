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

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse, up_conv
from instancerefer_tpu_torch.ops import gather_conv as G
from instancerefer_tpu_torch.ops.precision import rounding_gap

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
        assert (c, c) in G.K1_PAIRS and (c, c) in G.K2_PAIRS
    for c in widths[:-1]:
        assert (2 * c, c) in G.K1_PAIRS and (2 * c, c) in G.K2_PAIRS
        assert (c, c + 16) in G.K1_PAIRS and (c, c + 16) in G.K3_PAIRS
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


# K2's pairs whose warps split a block's offsets (WG > 1)
NARROW_K2 = ((16, 16), (32, 16), (32, 32), (48, 48))


def _cuh_int(name):
    with open(os.path.join(ROOT, "instancerefer_tpu_torch", "csrc", "sparse_conv_tc.cuh")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def test_dw_group_constants_are_the_sources():
    assert (_cuh_int("DWG_BR"), _cuh_int("DWG_G"), _cuh_int("DWG_WIDE_G")) == \
        (conv_bwd.DWG_BR, conv_bwd.DW_GROUP, conv_bwd.DWG_WIDE_G)


@pytest.mark.parametrize("cin, cout", G.K2_PAIRS)
def test_dw_group_split_covers_the_product(cin, cout):
    """K2's dW block: WG x WM x WN warps of 8 at most, WM x WN covering the
    [Cin, Cout] product, each warp's offsets' accumulators within 128; WG =
    8 // (WM x WN), so the warps idle only where no group fits."""
    wm, wn, wg, g = conv_bwd.dw_group_split(cin, cout)
    mt, nt = cin // 16 // wm, cout // 8 // wn
    assert wm * mt * 16 == cin and wn * nt * 8 == cout and nt % 2 == 0
    assert wg * wm * wn <= 8 < (wg + 1) * wm * wn
    assert 1 <= g <= 32 and -(-g // wg) * mt * nt * 4 <= 128
    assert conv_bwd.dw_group(cin, cout) == g


@pytest.mark.parametrize("cin, cout", G.K2_PAIRS)
def test_dw_group_split_keeps_the_wide_pairs(cin, cout):
    """Where WM x WN > 4 (every pair of 64 channels and above, so all that
    InstanceRefer's cells run) the block is warp_split's at two offsets a
    warp: WG = 1 and the same (WM, WN, G); G = 1 stays at 160 -> 80 and 192
    -> 96.  The groups of warps split the offsets at the narrow pairs alone."""
    wm, wn, wg, g = conv_bwd.dw_group_split(cin, cout)
    if wm * wn > 4:
        assert (wg, (wm, wn, g)) == (1, conv_bwd.warp_split(cin, cout, conv_bwd.DW_GROUP))
        assert g == (1 if (cin, cout) in ((160, 80), (192, 96)) else 2)
    assert (wg > 1) == ((cin, cout) in NARROW_K2)
    if min(cin, cout) >= 64:
        assert wg == 1


@pytest.mark.parametrize("cin, cout", G.K2_PAIRS)
def test_dw_group_shared_memory_fits(cin, cout):
    """A ring of 3 stages or more within a block's shared memory, and the
    blocks an SM the launch bounds take (``dw_group_blocks``) within the
    SM's."""
    smem = conv_bwd.dw_group_smem_bytes(cin, cout)
    assert conv_bwd.dw_group_stages(cin, cout, conv_bwd.dw_group(cin, cout)) >= 3
    assert smem <= G.SMEM_LIMIT
    blocks = conv_bwd.dw_group_blocks(cin, cout)
    assert 1 <= blocks <= conv_bwd.DWG_BLOCKS and blocks * (smem + 1024) <= conv_bwd.SM_SMEM


@pytest.mark.parametrize("cin, cout", NARROW_K2)
def test_dw_group_sweep_builds_only_blocks_that_fit(cin, cout):
    """``step_ab.DW_GROUPS``, the offsets a block the sweep's library is
    built for: each within the accumulators and the shared memory of a
    block with a ring of 3 stages or more, the rule's G among them."""
    from instancerefer_tpu_torch.scripts import step_ab

    wm, wn, wg, rule = conv_bwd.dw_group_split(cin, cout)
    _, groups = step_ab.DW_GROUPS[(cin, cout)]
    assert rule in groups and set(step_ab.DW_GROUPS) == set(NARROW_K2)
    for g in groups:
        assert -(-g // wg) * (cin // 16 // wm) * (cout // 8 // wn) * 4 <= 128
        assert conv_bwd.dw_group_stages(cin, cout, g) >= 3
        assert conv_bwd.dw_group_smem_bytes(cin, cout, g) <= G.SMEM_LIMIT


def test_conv_bytes_counts_a_block_of_many_offsets():
    """``scripts/conv_bytes.dw_bytes`` as G grows: the g rows staged do not
    change, x is staged once a tile for all 27 offsets at G = 27 (the tiles
    with a valid entry), a row's map entries are read once (the sectors
    they span), and the partials are written and read once a split."""
    from instancerefer_tpu_torch.scripts import conv_bytes

    gen = torch.Generator().manual_seed(21)
    nbr = _nbr3(gen, 700).numpy()
    g2 = conv_bytes.dw_bytes(nbr, 16, 16, 2, 3)
    g27 = conv_bytes.dw_bytes(nbr, 16, 16, 27, 5)
    assert g27[1] == g2[1]
    tiles = int(conv_bytes.active_pairs(nbr, 64).any(1).sum())
    assert g27[0] == tiles * 64 * 16 * 2 < g2[0]
    rows = np.arange(700)
    assert g27[2] == int(((rows * 27 + 26) * 4 // 32 - rows * 27 * 4 // 32 + 1).sum()) * 32 < g2[2]
    assert g27[3] == 2 * 5 * 27 * 16 * 16 * 4


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


def _close(got, want, tol, what="", stored=False):
    """max |got - want| within ``tol`` of max |want|; ``stored``: ``got``
    a bf16 output summed in f32 (K2's and the downs' dX), held so before
    its one rounding (``rounding_gap``)."""
    got, want = got.cpu(), want.float().cpu()
    top = want.abs().max().item() if want.numel() else 0.0
    if stored:
        assert got.dtype == torch.bfloat16, f"{what}: {got.dtype}"
        gap = rounding_gap(got, want)
    else:
        gap = (got.float() - want).abs()
    err = gap.max().item() if got.numel() else 0.0
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
            _close(a, c, TOL[torch.float32], f"K2 {name} {cin}->{cout}", stored=name == "dX")


def _nbr_sym(gen, v, k, fill=0.4):
    """A random k-offset map (k odd) over v rows, symmetric as the host
    maps are (offset k - 1 - j mirrors j), the centre the row itself, the
    first 100 rows empty (padding); in rows 640-703 (one tile) offsets 1, 3
    and 4 all -1, mirrors included."""
    c = k // 2
    nbr = torch.full((v, k), -1, dtype=torch.int32)
    nbr[:, c] = torch.arange(v, dtype=torch.int32)
    for j in range(c):
        pick = torch.rand(v, generator=gen) < fill
        other = torch.randint(0, v, (v,), generator=gen, dtype=torch.int32)
        src = torch.nonzero(pick)[:, 0]
        nbr[src, j] = other[src]
        nbr[other[src].long(), k - 1 - j] = src.int()
    nbr[:100] = -1
    nbr[torch.isin(nbr, torch.arange(100, dtype=torch.int32))] = -1
    for u in range(640, min(v, 704)):
        for j in (1, 3, 4):
            if nbr[u, j] >= 0:
                nbr[nbr[u, j].long(), k - 1 - j] = -1
            nbr[u, j] = -1
    return nbr


@pytest.mark.gpu
@pytest.mark.parametrize("k", [27, 7])
@pytest.mark.parametrize("cin, cout", NARROW_K2)
def test_k2_dw_at_narrow_pairs_on_card(monkeypatch, cin, cout, k):
    """K2 where the warps split a block's offsets: K = 27 and 7 (at each
    pair one of them no multiple of G, so a block takes fewer offsets than
    G), 12000 and 150 rows (no multiple of 64), a padding tile and a tile
    with three offsets' columns all -1, under the plan's splits and under
    more splits than row tiles (empty ranges): dX and dW against the twin,
    a second launch equal to the bit."""
    dev = _card()
    gen = torch.Generator().manual_seed(cin * 1000 + cout + k)
    group = conv_bwd.dw_group(cin, cout)
    assert 27 % group or 7 % group
    for v in (12000, 150):
        nbr = _nbr_sym(gen, v, k)
        x, g, w = _bf(gen, v, cin), _bf(gen, v, cout), _bf(gen, k, cin, cout)
        want = sparse.subm_conv_bwd(x, nbr, g, w)
        for splits in (None, -(-v // 64) + 3):
            if splits is not None:
                monkeypatch.setattr(conv_bwd, "dw_plan",
                                    lambda *a, s=splits: conv_bwd.DwPlan(group, s))
            args = (x.to(dev), nbr.to(dev), g.to(dev), w.to(dev))
            got, again = conv_bwd.subm_conv_bwd(*args), conv_bwd.subm_conv_bwd(*args)
            for name, a, b, c in zip(("dX", "dW"), got, again, want):
                what = f"K2 {name} {cin}->{cout} K={k} V={v} splits={splits}"
                assert torch.equal(a, b), f"{what}: a second launch differs"
                _close(a, c, TOL[torch.float32], what, stored=name == "dX")
            monkeypatch.undo()


@pytest.mark.gpu
def test_dw_group_block_matches_the_card_on_card():
    """At every K2 pair the library's block (``ir_dw_group_split``) is the
    host's ``dw_group_split``, and the card runs as many blocks an SM as
    ``dw_group_blocks`` says, the count ``dw_plan`` fills the card by and
    the kernel's launch bounds."""
    _card()
    lib = G.library("subm_conv_bwd")
    lib.ir_dw_group_occupancy.restype = ctypes.c_int
    out, regs, bound = (ctypes.c_int * 4)(), ctypes.c_int(), ctypes.c_int()
    for cin, cout in G.K2_PAIRS:
        lib.ir_dw_group_split(cin, cout, out)
        assert tuple(out) == conv_bwd.dw_group_split(cin, cout)
        blocks = lib.ir_dw_group_occupancy(cin, cout, ctypes.byref(regs), ctypes.byref(bound))
        assert blocks == bound.value == conv_bwd.dw_group_blocks(cin, cout), \
            (cin, cout, blocks, bound.value, regs.value)


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
               TOL[torch.float32], "down dX", stored=True)
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
    for cin, cout in G.K1_PAIRS:
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
