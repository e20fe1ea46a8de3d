"""The tile plans of K1's tensor-core gather-GEMM (``ops/gather_conv.tc_plan``,
which K2's dX shares) and of K2's dW (``ops/conv_bwd.dw_plan``), and the
kernels of each plan branch against their plain twins on the card.

On the CPU: every K1 tensor-core launch and every K2 launch of a train and
an eval step gets a plan the C entries are built for, at
``config/band_profile.synthetic.yaml``'s caps at B = 32 and B = 64 and at
``synthetic.TEST_SPEC`` (the shapes of ``scripts/step_ab.SHAPES``, held
against the launches a CPU train step records); the same shape always gets
the same plan; a block's shared memory stays within an H100's 232,448
bytes; K2's dW partials within ``DW_PARTIAL_BYTES``; the wrappers hand the
plans to the C entries, and a plan outside what those are built for
raises before any launch.

On the card (``@pytest.mark.gpu``, skipped here): each plan the kernels are
built for (64-row tiles alone and split over clusters of 2 and 4) and K2's
dW at several splits against the plain twin, on a ragged last tile, tiles
whose map is all -1, fewer rows than one tile and none; K1 and K2
bit-identical over two launches; the host's shared-memory sizes equal to
the built libraries', and the C entries refusing a plan they are not built
for.  This file imports no JAX, so on a card it runs without the
repo's conftest: ``python -m pytest tests/test_torch_conv_plan.py -m gpu
--noconftest``.  Tolerances as in ``chip_smoke.py``: bf16 outputs within
1e-2 of the largest value (one bf16 ulp where two f32 sums round apart),
f32 outputs within 1e-5 and dW within 1e-4 of the largest value.
"""

import os

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.config import band_profile_kwargs
from instancerefer_tpu_torch.data.pipeline import BatchSpec
from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
from instancerefer_tpu_torch.ops import conv_bwd, sparse
from instancerefer_tpu_torch.ops import gather_conv as G
from instancerefer_tpu_torch.ops.precision import rounding_gap
from instancerefer_tpu_torch.scripts import step_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = os.path.join(REPO, "config", "band_profile.synthetic.yaml")
H100_SMS = 132
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
SCENE_KW = dict(num_points=40000, num_instances=12, num_candidates=4)  # the bench's scenes
TC = ("gather_conv", "gather_conv_dx", "subm_conv_bwd")


def _profile_spec():
    caps = band_profile_kwargs(PROFILE)
    return BatchSpec(**{k: caps[k] for k in ("scene_caps", "inst_caps", "max_candidates",
                                            "max_instances")})


@pytest.fixture(scope="module")
def batches():
    """Host batches: B = 32 and 64 at the profile's caps (the bench's
    scenes), and B = 2 at TEST_SPEC."""
    spec = _profile_spec()
    out = {f"B={b}": make_batch(b, spec, seed=0, mean_size_arr=MEAN_SIZE, **SCENE_KW)
           for b in (32, 64)}
    out["TEST_SPEC"] = make_batch(2, TEST_SPEC, seed=0, mean_size_arr=MEAN_SIZE)
    return out


def _tc_launches(batch):
    """(label, wrapper, rows, K, Cin, Cout) of every K1 tensor-core and K2
    shape of a train step on ``batch``."""
    out = []
    for label, wrapper, key, _, cin, cout in step_ab.SHAPES:
        if wrapper in TC and cin in G.TC_WIDTHS:
            v, k = step_ab.shape_map(batch, key).shape
            out.append((label, wrapper, v, k, cin, cout))
    return out


def _plans(wrapper, v, k, cin, cout, sms=H100_SMS):
    if wrapper == "subm_conv_bwd":  # dX reduces over Cout into Cin, stored bf16
        return (G.tc_plan(v, k, cout, cin, torch.bfloat16, sms),
                conv_bwd.dw_plan(v, k, cin, cout, sms))
    return (G.tc_plan(v, k, cin, cout, torch.bfloat16, sms),)


@pytest.mark.parametrize("which", ["B=32", "B=64", "TEST_SPEC"])
def test_every_tensor_core_launch_gets_a_built_plan(batches, which):
    """32 K1 tensor-core launches and 16 K2 launches a train step (24 K1 an
    eval step, the forward's shapes), 8 K1 shapes of 2 launches (the
    residuals) or 1 (the downs, their dX) and 8 K2 shapes of 2, each
    with a plan the C entries are built for, within the shared memory and
    partials a block and a call may take, the same on every call.  The
    downs' dX runs over the down map's lists: its blocks a list fill at
    most the card's slots."""
    launches = _tc_launches(batches[which])
    list_plans = step_ab.shape_plans(batches[which], H100_SMS)
    counts = {"gather_conv": 0, "gather_conv_dx": 0, "subm_conv_bwd": 0}
    for label, wrapper, v, k, cin, cout in launches:
        counts[wrapper] += 2 if "residual" in label else 1
        if wrapper == "gather_conv_dx":  # Cin -> Cout of the dX: the down's Cout -> Cin
            route, splits = list_plans[label]
            assert route == "lists" and splits >= 1
            assert splits * k <= conv_bwd.dx_list_blocks(cout, cin) * H100_SMS
            assert conv_bwd.dx_list_smem_bytes(cout, cin) <= G.SMEM_LIMIT
            continue
        plans = _plans(wrapper, v, k, cin, cout)
        assert plans == _plans(wrapper, v, k, cin, cout)  # a function of the shape
        plan = plans[0]
        G.check_plan(label, plan)
        assert plan.offsets_per_block == -(-k // plan.cluster)
        red, nout = (cout, cin) if wrapper == "subm_conv_bwd" else (cin, cout)
        smem = G.tc_smem_bytes(k, red, nout, mirror=wrapper == "subm_conv_bwd")
        assert smem <= G.SMEM_LIMIT
        if wrapper == "subm_conv_bwd":
            dwp = plans[1]
            assert dwp.group == conv_bwd.dw_group(cin, cout) == 2 and dwp.splits >= 1
            smem = conv_bwd.dw_group_smem_bytes(cin, cout)
            assert smem <= G.SMEM_LIMIT
            assert dwp.splits * k * cin * cout * 4 <= conv_bwd.DW_PARTIAL_BYTES
            # no more blocks than the card's slots: the blocks an SM holds x SMs
            per_sm = conv_bwd.dw_group_blocks(cin, cout)
            assert per_sm * (smem + 1024) <= conv_bwd.SM_SMEM
            assert -(-k // dwp.group) * dwp.splits <= per_sm * H100_SMS
    assert counts == {"gather_conv": 24, "gather_conv_dx": 8, "subm_conv_bwd": 16}


def test_shapes_are_the_launches_of_a_train_step(batches):
    """The K1 tensor-core and K2 shapes of ``step_ab.SHAPES`` are what a
    train step (and its eval forward) launches: a CPU train step at
    TEST_SPEC, its wrapper calls recorded."""
    import chip_smoke as cs
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    batch = batches["TEST_SPEC"]
    model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                          generator=torch.Generator().manual_seed(0))
    dd = batch_to_torch(batch, TEST_SPEC, "cpu")
    with cs.record_launches() as calls:
        train_step(model, make_optimizer(model.parameters(), 1e-3, 1e-5), dd,
                   torch.tensor(MEAN_SIZE, dtype=torch.float32))
    got = {}
    for c in calls:  # K1's forward and dX over up8 alike (f32 here)
        if c["cin"] in G.TC_WIDTHS and c["kernel"] != "K3":
            key = (c["kernel"], c["v_out"], c["k"], c["cin"], c["cout"])
            got[key] = got.get(key, 0) + 1
    want = {}
    for label, wrapper, v, k, cin, cout in _tc_launches(batch):
        key = ("K2" if wrapper == "subm_conv_bwd" else "K1", v, k, cin, cout)
        want[key] = want.get(key, 0) + (2 if "residual" in label else 1)
    assert got == want


@pytest.mark.parametrize("rows, k, dt, want", [
    (278528, 27, torch.bfloat16, (64, 1)), (81920, 27, torch.float32, (64, 1)),
    (16897, 27, torch.bfloat16, (64, 1)), (16896, 27, torch.bfloat16, (64, 2)),
    (16384, 27, torch.float32, (64, 2)), (8448, 27, torch.bfloat16, (64, 4)),
    (8192, 27, torch.float32, (64, 4)), (100, 27, torch.bfloat16, (64, 4)),
    (278528, 8, torch.bfloat16, (64, 1)), (100000, 8, torch.bfloat16, (64, 1)),
    (99999, 8, torch.bfloat16, (64, 1)), (1163264, 8, torch.float32, (64, 1)),
    (8192, 8, torch.bfloat16, (64, 1)), (1, 1, torch.bfloat16, (64, 1)),
])
def test_plan_branches(rows, k, dt, want):
    """64-row tiles; a 3^3 map's offsets split over a cluster of 2 where its
    tiles are at most twice the SMs (2 x 132 x 64 = 16896 rows), of 4 where
    at most the SMs (8448 rows); a 2^3 map's never."""
    plan = G.tc_plan(rows, k, 128, 64, dt, H100_SMS)
    assert (plan.bm, plan.cluster) == want
    assert plan.offsets_per_block == -(-k // plan.cluster)
    # the card's SM count is part of the shape's key
    assert G.tc_plan(16384, 27, 128, 128, torch.bfloat16, 40) == G.TcPlan(64, 1, 27)


# K2's shapes in the train cells: the rows of InstanceRefer's stages at B =
# 32 and 64 (the residuals' maps of step_ab.SHAPES) and of PointGroup's
# levels, a batch of 4 rooms at its configuration's caps
PG_LEVEL_ROWS = tuple(4 * c for c in (250048, 182208, 57216, 15936, 5184, 1280, 256))


def test_k2_dx_keeps_the_plan_of_its_f32_store(batches):
    """K2's dX stores bf16 where it stored f32: at every K2 shape of the
    three train cells and at each K2 pair the plan (tile, cluster) is the
    one the f32 store ran under."""
    rows = {v for b in ("B=32", "B=64") for _, wrapper, v, _, _, _ in _tc_launches(batches[b])
            if wrapper == "subm_conv_bwd"} | set(PG_LEVEL_ROWS)
    assert len(rows) >= 10
    for v in sorted(rows):
        for cin, cout in G.K2_PAIRS:
            assert G.tc_plan(v, 27, cout, cin, torch.bfloat16, H100_SMS) == \
                G.tc_plan(v, 27, cout, cin, torch.float32, H100_SMS), (v, cin, cout)


def test_plans_refuse_what_they_do_not_cover():
    for bad in ((0, 27, 64, 64, H100_SMS), (10, 0, 64, 64, H100_SMS), (10, 27, 64, 64, 0),
                (10, 27, 40, 64, H100_SMS), (10, 27, 64, 256, H100_SMS)):
        with pytest.raises(ValueError):
            G.tc_plan(*bad[:4], torch.bfloat16, bad[4])
    with pytest.raises(ValueError):
        G.tc_plan(10, 27, 64, 64, torch.float16, H100_SMS)
    with pytest.raises(ValueError):
        conv_bwd.dw_plan(0, 27, 64, 64, H100_SMS)
    with pytest.raises(ValueError):
        conv_bwd.dw_group_smem_bytes(48, 64)
    for bm, cs in ((32, 1), (256, 1), (128, 1), (128, 2), (128, 4), (64, 8)):
        with pytest.raises(ValueError, match="built"):
            G.check_plan("k", G.TcPlan(bm, cs, 27))
    for plan in G.TC_PLANS:
        G.check_plan("k", G.TcPlan(*plan, 27))


def test_shared_memory_and_groups_of_every_width():
    """The gather-GEMM at every width (K = 8 and 27, mirrored or not) and
    K2's dW at every width within one block's shared memory, the
    gather-GEMM with room for two blocks an SM; K2's dW holds at most 128
    accumulators a thread (G = 2 at 128 -> 128 reaches it; a warp takes
    ceil(G / WG) of a block's offsets)."""
    for red in G.TC_WIDTHS:
        for nout in G.TC_WIDTHS:
            for k in (8, 27):
                for mirror in (False, True):
                    smem = G.tc_smem_bytes(k, red, nout, mirror)
                    assert 2 * (smem + 1024) <= conv_bwd.SM_SMEM
    for ci in G.TC_WIDTHS:
        for co in G.TC_WIDTHS:
            assert conv_bwd.dw_group_smem_bytes(ci, co) <= G.SMEM_LIMIT
            wm, wn, wg, g = conv_bwd.dw_group_split(ci, co)
            acc = -(-g // wg) * ci * co // (wm * wn * 32)  # accumulators a thread
            assert acc <= 128 and (acc == 128) == (ci == co == 128)


def test_dw_partials_shrink_against_the_old_split_rule():
    """K2's partials and their sum at its train-step widths: fewer splits
    than the (K, split) grid's rule, within DW_PARTIAL_BYTES."""
    for rows, c in ((139264, 64), (278528, 64), (40960, 128), (81920, 128), (8192, 128)):
        plan = conv_bwd.dw_plan(rows, 27, c, c, H100_SMS)
        old = conv_bwd.dw_splits(rows, 27, "tensor_core")
        assert plan.splits < old
        assert plan.splits * 27 * c * c * 4 <= conv_bwd.DW_PARTIAL_BYTES


# PointGroup's cell: the rows of a batch of 4 rooms at levels 0, 1 and 2
# (benchmark/configs/pointgroup-scannet-m16.json's level_caps)
PG_LEVEL_ROWS = (4 * 250048, 4 * 182208, 4 * 57216)


@pytest.mark.parametrize("cin, cout", G.K2_PAIRS)
def test_dw_plan_at_pointgroup_levels(cin, cout):
    """K2's dW plan at the rows of the cell's levels 0-2: the block's G,
    splits that fill the card's slots (``dw_group_blocks`` an SM) in one
    wave, at most ``DW_PARTIAL_BYTES`` of partials; where WG = 1 the splits
    the rule had before the warp groups (the SM's blocks by shared memory
    alone, at two offsets a block but at 160 -> 80 and 192 -> 96)."""
    g = conv_bwd.dw_group(cin, cout)
    wg = conv_bwd.dw_group_split(cin, cout)[2]
    for rows in PG_LEVEL_ROWS:
        plan = conv_bwd.dw_plan(rows, 27, cin, cout, H100_SMS)
        assert plan.group == g and plan.splits >= 1
        per_sm = conv_bwd.dw_group_blocks(cin, cout)
        assert -(-27 // g) * plan.splits <= per_sm * H100_SMS
        assert plan.splits * 27 * cin * cout * 4 <= conv_bwd.DW_PARTIAL_BYTES
        if wg == 1:
            old_per_sm = conv_bwd.SM_SMEM // (conv_bwd.dw_group_smem_bytes(cin, cout) + 1024)
            assert per_sm == old_per_sm and g == conv_bwd.warp_split(cin, cout, 2)[2]
            assert plan.splits == min(-(-rows // 512), old_per_sm * H100_SMS // -(-27 // g),
                                      conv_bwd.DW_PARTIAL_BYTES // (4 * 27 * cin * cout))


def _fake_card(monkeypatch):
    """The card's routes on CPU tensors, the C entries faked: [(entry name,
    the ints it was given)]."""
    calls = []

    def entry(*key):
        name = next(k for k in key if str(k).startswith("ir_"))
        return lambda *args: calls.append((name, list(args))) or 0

    route = G.route
    for module in (G, conv_bwd):
        monkeypatch.setattr(module, "_entry", entry)
        monkeypatch.setattr(module, "cuda_stream", lambda t: 0)
        monkeypatch.setattr(module, "route", lambda dtype, cin, device: route(dtype, cin, "cuda"))
        monkeypatch.setattr(module, "sm_count", lambda device: H100_SMS)
    return calls


def test_wrappers_hand_the_plans_to_the_entries(monkeypatch):
    calls = _fake_card(monkeypatch)
    x = torch.zeros(20000, 128, dtype=torch.bfloat16)
    nbr = torch.zeros(16384, 27, dtype=torch.int32)
    w = torch.zeros(27, 128, 128, dtype=torch.bfloat16)
    G.gather_conv(x, nbr, w)
    conv_bwd.subm_conv_bwd(x[:16384], nbr, x[:16384], w)
    plan = G.tc_plan(16384, 27, 128, 128, torch.bfloat16, H100_SMS)
    dwp = conv_bwd.dw_plan(16384, 27, 128, 128, H100_SMS)
    assert (plan.bm, plan.cluster) == (64, 2) and dwp == (2, 9)
    # (rows, K, Cin, Cout, relu, bm, cluster; stream), after the pointers;
    # K2: (rows, K, Cin, Cout, splits, bm, cluster, G; stream)
    assert [(name, args[7 if "subm" in name else 6:]) for name, args in calls] == [
        ("ir_gather_conv_tc", [16384, 27, 128, 128, 0, 64, 2, 0]),
        ("ir_subm_conv_bwd_tc", [16384, 27, 128, 128, 9, 64, 2, 2, 0]),
    ]


@pytest.mark.parametrize("bm, cs", [(32, 1), (128, 1), (128, 2)])
def test_a_plan_outside_the_build_raises(monkeypatch, bm, cs):
    """No launch, no fallback: the wrappers raise on a plan the C entries
    are not built for (they would refuse it too)."""
    calls = _fake_card(monkeypatch)
    bad = lambda *a: G.TcPlan(bm, cs, 27)  # noqa: E731
    monkeypatch.setattr(G, "tc_plan", bad)
    monkeypatch.setattr(conv_bwd, "tc_plan", bad)
    x = torch.zeros(300, 64, dtype=torch.bfloat16)
    nbr = torch.zeros(300, 27, dtype=torch.int32)
    w = torch.zeros(27, 64, 64, dtype=torch.bfloat16)
    before = (G.gather_conv.launches, conv_bwd.subm_conv_bwd.launches)
    with pytest.raises(ValueError, match="built"):
        G.gather_conv(x, nbr, w)
    with pytest.raises(ValueError, match="built"):
        conv_bwd.subm_conv_bwd(x, nbr, x, w)
    assert calls == [] and (G.gather_conv.launches, conv_bwd.subm_conv_bwd.launches) == before


# ---------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _force(monkeypatch, plan):
    """Every tensor-core gather-GEMM launch takes ``plan`` (bm, cluster)."""
    forced = lambda v, k, red, nout, dt, sms: G.TcPlan(*plan, -(-k // plan[1]))  # noqa: E731
    monkeypatch.setattr(G, "tc_plan", forced)
    monkeypatch.setattr(conv_bwd, "tc_plan", forced)


def _map(gen, v_out, v_in, k, dev):
    """40% valid; rows 256-511 all -1 (four tiles of padding), one offset
    empty in rows 600-700 and one offset empty everywhere; v_out need not
    fill the last tile."""
    nbr = torch.randint(0, v_in, (v_out, k), generator=gen, device=dev, dtype=torch.int32)
    nbr[torch.rand(v_out, k, generator=gen, device=dev) >= 0.4] = -1
    nbr[256:512] = -1
    nbr[600:700, 3 % k] = -1
    nbr[:, 5 % k] = -1
    return nbr.contiguous()


def _close(got, ref, tol):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _close_stored(got, ref, tol):
    """``_close`` for a bf16 output summed in f32 (K2's dX): within ``tol``
    of the f32 ``ref`` before its one rounding (``rounding_gap``)."""
    assert got.dtype == torch.bfloat16 and ref.dtype == torch.float32
    scale = ref.abs().max().item()
    err = rounding_gap(got, ref).max().item()
    assert err <= tol * max(scale, 1e-30), (err, scale)


ROWS = [1000, 50, 0]  # a ragged last tile (and padding tiles), less than a tile, none


@pytest.mark.gpu
@pytest.mark.parametrize("v_out", ROWS)
@pytest.mark.parametrize("plan", G.TC_PLANS)
@pytest.mark.parametrize("k, cin, cout", [(27, 64, 64), (27, 128, 128), (8, 32, 64),
                                          (8, 128, 128)])
def test_k1_plan_matches_twin_on_card(monkeypatch, plan, v_out, k, cin, cout):
    """K1 at each plan: bf16 out with the epilogue (padding tiles store
    relu(bias)); bit-identical over two launches."""
    dev = _card()
    _force(monkeypatch, plan)
    gen = torch.Generator(device=dev).manual_seed(cin + cout + k + v_out + plan[0] + plan[1])
    nbr = _map(gen, v_out, 900, k, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    w = (torch.randn(k, cin, cout, device=dev, generator=gen) / (k * cin) ** 0.5).bfloat16()
    sc = 0.5 + torch.rand(cout, device=dev, generator=gen)
    bi = 0.1 * torch.randn(cout, device=dev, generator=gen)
    before = G.gather_conv.launches
    got = G.gather_conv(x, nbr, w, sc, bi, relu=True)
    assert G.gather_conv.launches == before + (v_out > 0)
    assert got.shape == (v_out, cout) and got.dtype == torch.bfloat16
    if v_out == 0:
        return
    _close(got, sparse.gather_conv(x, nbr, w, sc, bi, relu=True), 1e-2)
    if v_out > 512:
        assert torch.equal(got[256:512].float(),
                           torch.relu(bi).bfloat16().float().expand(256, cout))
    assert torch.equal(got, G.gather_conv(x, nbr, w, sc, bi, relu=True))


@pytest.mark.gpu
@pytest.mark.parametrize("v", ROWS)
@pytest.mark.parametrize("plan", G.TC_PLANS)
@pytest.mark.parametrize("cin, cout, splits", [(64, 64, 1), (64, 64, 3), (128, 128, 2),
                                               (128, 128, 40), (64, 128, 3), (32, 32, 3)])
def test_k2_plan_matches_twin_on_card(monkeypatch, plan, v, cin, cout, splits):
    """K2 at each dX plan, its dW over 1 to 40 splits (more splits than row
    tiles leave some empty): dX and dW against the twin, padding rows' dX
    zero, dX and dW bit-identical over two launches."""
    dev = _card()
    _force(monkeypatch, plan)
    monkeypatch.setattr(conv_bwd, "dw_plan",
                        lambda *a: conv_bwd.DwPlan(conv_bwd.dw_group(cin, cout), splits))
    gen = torch.Generator(device=dev).manual_seed(cin * cout + v + plan[0] + plan[1] + splits)
    nbr = _map(gen, v, max(v, 1), 27, dev)
    x = torch.randn(v, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(v, cout, device=dev, generator=gen).bfloat16()
    w = (torch.randn(27, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5).bfloat16()
    before = conv_bwd.subm_conv_bwd.launches
    dx, dw = conv_bwd.subm_conv_bwd(x, nbr, g, w)
    assert conv_bwd.subm_conv_bwd.launches == before + (v > 0)
    assert dx.shape == (v, cin) and dw.shape == (27, cin, cout)
    if v == 0:
        assert torch.equal(dw, torch.zeros_like(dw))
        return
    ref_dx, ref_dw = sparse.subm_conv_bwd(x, nbr, g, w)
    _close_stored(dx, ref_dx, 1e-5)
    _close(dw, ref_dw, 1e-4)
    assert torch.equal(dw[27 - 1 - 5], torch.zeros_like(dw[0]))  # offset 5 is empty
    if v > 512:
        assert torch.equal(dx[256:512], torch.zeros_like(dx[256:512]))
    dx2, dw2 = conv_bwd.subm_conv_bwd(x, nbr, g, w)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)  # bit-identical


@pytest.mark.gpu
def test_natural_plans_at_main_path_sizes_on_card():
    """Without forcing: rows that pick each branch by themselves (64-row
    tiles alone at 70000 rows; clusters of 2 and 4 at 16384 and 8192), K1
    and K2 against their twins, and a bf16 down conv at a stage-1 size."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    down = _map(gen, 120000, 130000, 8, dev)
    x = torch.randn(130000, 64, device=dev, generator=gen).bfloat16()
    w = (torch.randn(8, 64, 128, device=dev, generator=gen) / 512 ** 0.5).bfloat16()
    assert G.tc_plan(120000, 8, 64, 128, torch.bfloat16, G.sm_count(dev))[:2] == (64, 1)
    _close(G.gather_conv(x, down, w), sparse.gather_conv(x, down, w), 1e-2)
    for v, c in ((70000, 64), (16384, 128), (8192, 128)):
        nbr = _map(gen, v, v, 27, dev)
        x = torch.randn(v, c, device=dev, generator=gen).bfloat16()
        w = (torch.randn(27, c, c, device=dev, generator=gen) / (27 * c) ** 0.5).bfloat16()
        _close(G.gather_conv(x, nbr, w), sparse.gather_conv(x, nbr, w), 1e-2)
        dx, dw = conv_bwd.subm_conv_bwd(x, nbr, x, w)
        ref_dx, ref_dw = sparse.subm_conv_bwd(x, nbr, x, w)
        _close_stored(dx, ref_dx, 1e-5)
        _close(dw, ref_dw, 1e-4)


@pytest.mark.gpu
def test_shared_memory_sizes_match_the_build_on_card():
    """The host's shared-memory sizes (``tc_smem_bytes``, which the CPU tests
    bound, and ``dw_group_smem_bytes``, which ``dw_plan`` sizes its splits
    by) equal what the built kernels reserve."""
    import ctypes

    _card()
    tile = G.library("gather_conv").ir_tc_smem_bytes
    group = G.library("subm_conv_bwd").ir_dw_group_smem_bytes
    for fn in (tile, group):
        fn.restype = ctypes.c_longlong
    for red in G.TC_WIDTHS:
        for nout in G.TC_WIDTHS:
            for k in (8, 27):
                for mirror in (False, True):
                    assert tile(red, nout, int(mirror), k) == G.tc_smem_bytes(k, red, nout, mirror)
            assert group(red, nout) == conv_bwd.dw_group_smem_bytes(red, nout)


@pytest.mark.gpu
@pytest.mark.parametrize("bm, cs", [(128, 1), (64, 3), (64, 8)])
def test_entries_refuse_an_unbuilt_plan_on_card(bm, cs):
    """The C entries themselves refuse a plan they are not built for
    (cudaErrorInvalidValue), past the wrappers' check; nothing launches."""
    dev = _card()
    x = torch.zeros(300, 64, dtype=torch.bfloat16, device=dev)
    nbr = torch.zeros(300, 27, dtype=torch.int32, device=dev)
    w = torch.zeros(27, 64, 64, dtype=torch.bfloat16, device=dev)
    out = torch.empty(300, 64, dtype=torch.float32, device=dev)
    dw = torch.empty(27, 64, 64, dtype=torch.float32, device=dev)
    partial = torch.empty(4, 27, 64, 64, dtype=torch.float32, device=dev)
    stream = G.cuda_stream(x)
    rc = G._entry("ir_gather_conv_tc", 2)(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), None, None, out.data_ptr(), 300, 27, 64, 64,
        0, bm, cs, stream)
    assert rc == 1  # cudaErrorInvalidValue
    rc = conv_bwd._entry("subm_conv_bwd", "ir_subm_conv_bwd_tc", 7, 7)(
        x.data_ptr(), nbr.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), 300, 27, 64, 64, 4, bm, cs, conv_bwd.DW_GROUP, stream)
    assert rc == 1
    rc = conv_bwd._entry("subm_conv_bwd", "ir_subm_conv_bwd_tc", 7, 7)(
        x.data_ptr(), nbr.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), 300, 27, 64, 64, 4, 64, 1, 3, stream)
    assert rc == 1  # a dW group it is not built for
