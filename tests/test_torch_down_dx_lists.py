"""The down convs' dX over the per-offset lists of their map
(``ops/conv_bwd.down_dx``; ``csrc/sparse_conv_tc.cuh``'s
``dx_list_tc_kernel``), and the one list pass (``conv_bwd.down_lists``)
that it and K3 share in ``ops/sparse_conv.DownConv.backward``.

* The plain list-form dX (``conv_bwd.down_dx_plain``) in the kernel's
  order (each split's range of each list, ``dw_list_ranges``, at the
  splits an H100 takes and at 7, so that ranges end mid-tile; tiles of
  ``DXL_BR`` entries) and over whole lists (as the CPU runs it), against
  ``sparse.gather_conv`` over the inverse map ``up8`` with W^T, against
  the TPU kernel ``windowed_gather_conv`` over ``up8`` in interpret mode
  and against the JAX package's fallback form (a row gather by ``up_row``
  and per-offset masked GEMMs, ``instancerefer_tpu/ops/sparse.py:327-336``),
  on drop-free banded maps.
* ``DownConv``'s CPU gradients against ``down_gather_conv``'s VJP.
* The down maps of the bench's synthetic batch of 64 name each input row
  at most once, and the rows they do not name come out 0.
* The splits, the shared memory, and the wiring on the card's route (the C
  entries faked): one list pass, then the dX entry and K3's entry over the
  same workspace, counted as one K1 and one K3 launch; the byte counts of
  ``scripts/conv_bytes.py``.

f32 on every side, sums in another order: within 1e-5 of the largest
value.  The card tests (``@pytest.mark.gpu``) skip without a CUDA device:
the kernel against its plain version at the 8 down shapes of a train step
at B = 64, bf16 in and out (within 1e-5 before the store's one rounding,
``precision.rounding_gap``), its f32 store rounded to bf16 equal to its
bf16 store, two launches bit-identical, the rows no entry names 0.  JAX is imported only inside the CPU tests that compare with
it, so on a card this file runs without the repo's conftest: ``python -m
pytest tests/test_torch_down_dx_lists.py -m gpu --noconftest``.
"""

import itertools

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, precision, sparse, sparse_conv
from instancerefer_tpu_torch.ops import gather_conv as G
from instancerefer_tpu_torch.ops.precision import rounding_gap

H100_SMS = 132
TOL = 1e-5  # of the largest value: f32 sums in another order
WIDTHS = ((32, 64), (64, 128), (128, 128))  # the downs' Cin -> Cout
CAP0, CAP1 = 2048, 512
CHUNK, WINDOW, SUBWIN = 128, 512, 384
# the eight downs of a train step at the bench's batch of 64: (V_out, V_in, Cin, Cout)
BENCH_DOWNS = ((278528, 1163264, 32, 64), (81920, 278528, 64, 128), (32768, 81920, 128, 128),
               (16384, 32768, 128, 128), (114688, 114688, 32, 64), (81920, 114688, 64, 128),
               (32768, 81920, 128, 128), (16384, 32768, 128, 128))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def down_map():
    """A stage-1 ``down`` map (K = 8, rows of stage 0) of two
    raster-ordered scenes, flattened as collate does, its inversion
    (``up_row``, ``up_k``) and ``up8``."""
    from instancerefer_tpu.ops import voxelize as V

    rng = np.random.default_rng(0)
    down = []
    for b in range(2):
        pts = rng.uniform(0, 2.5, size=(2500, 3))
        coords, _ = V.quantize(pts, pts.astype(np.float32), 0.05, raster_order=True)
        pyr = V.build_pyramid(coords, owner=0, num_stages=2, caps=[CAP0, CAP1], raster=True)
        st = V.pad_stage(pyr[1], CAP1, CAP0)
        down.append(np.where(st.down >= 0, st.down + b * CAP0, -1))
    down = np.concatenate(down).astype(np.int32)
    up_row, up_k = V.invert_down(down, 2 * CAP0)
    return down, up_row, up_k, V.build_up8(up_row, up_k)


def _inputs(down, cin, cout):
    rng = np.random.default_rng(cin + cout)
    g = rng.normal(size=(down.shape[0], cout)).astype(np.float32)
    w = (rng.normal(size=(8, cin, cout)) / np.sqrt(8 * cin)).astype(np.float32)
    return g, w


def _plain(g, down, w, v_in, splits):
    nt = torch.from_numpy(down)
    lists, counts = conv_bwd.dw_lists_plain(nt)
    return conv_bwd.down_dx_plain(torch.from_numpy(g), nt, torch.from_numpy(w), lists, counts,
                                  v_in, splits).numpy()


def _splits(down, cin, cout):
    """The kernel's order at an H100's splits and at 7, and whole lists
    (None: what ``down_dx`` runs on the CPU)."""
    return (conv_bwd.dx_list_splits(down.shape[0], 8, cin, cout, H100_SMS), 7, None)


@pytest.mark.parametrize("cin, cout", WIDTHS)
def test_plain_list_dx_matches_the_twin_over_up8(down_map, cin, cout):
    """The list form in the kernel's order against K1's plain twin over
    ``up8`` with W^T, f32 out; the rows no entry names are exactly 0."""
    down, _, _, up8 = down_map
    g, w = _inputs(down, cin, cout)
    want = sparse.gather_conv(torch.from_numpy(g), torch.from_numpy(up8),
                              torch.from_numpy(w).transpose(1, 2).contiguous(),
                              out_dtype=torch.float32).numpy()
    uncovered = (up8 < 0).all(1)
    assert uncovered.any() and not uncovered.all()
    for splits in _splits(down, cin, cout):
        got = _plain(g, down, w, up8.shape[0], splits)
        _close(got, want)
        assert (got[uncovered] == 0).all()


@pytest.mark.parametrize("cin, cout", WIDTHS)
def test_plain_list_dx_matches_the_pallas_kernel_over_up8(down_map, cin, cout):
    """Against the TPU kernel ``windowed_gather_conv`` over ``up8`` with
    W^T in interpret mode, as the JAX package's down-conv backward runs it
    (``sparse.py:321-326``)."""
    import jax.numpy as jnp

    from instancerefer_tpu.ops import voxelize as V
    from instancerefer_tpu.ops.pallas_conv import windowed_gather_conv

    down, _, _, up8 = down_map
    g, w = _inputs(down, cin, cout)
    ws, wskt, dropped, total = V.compute_offset_window_starts(
        up8, CHUNK, WINDOW, SUBWIN, down.shape[0], count_drops=True)
    assert dropped == 0 and total == int((up8 >= 0).sum())
    want = np.asarray(windowed_gather_conv(
        jnp.asarray(g), jnp.asarray(up8), jnp.transpose(jnp.asarray(w), (0, 2, 1)),
        jnp.asarray(ws), jnp.asarray(wskt), window=WINDOW, chunk=CHUNK, subwin=SUBWIN,
        out_dtype=jnp.float32, interpret=True))[:, :cin]
    for splits in _splits(down, cin, cout):
        _close(_plain(g, down, w, up8.shape[0], splits), want)


@pytest.mark.parametrize("cin, cout", WIDTHS)
def test_plain_list_dx_matches_the_jax_fallback_form(down_map, cin, cout):
    """Against the JAX backward's fallback: one row gather of g by
    ``up_row``, then per offset a GEMM of the rows whose ``up_k`` is it
    (``sparse.py:327-336``)."""
    import jax.numpy as jnp

    from instancerefer_tpu.ops.sparse import gather_rows

    down, up_row, up_k, up8 = down_map
    g, w = _inputs(down, cin, cout)
    tmp = gather_rows(jnp.asarray(g), jnp.asarray(up_row))
    w_t = jnp.transpose(jnp.asarray(w), (0, 2, 1))
    want = jnp.zeros((up8.shape[0], cin), jnp.float32)
    for i in range(8):
        sel = (jnp.asarray(up_k) == i)[:, None].astype(tmp.dtype)
        want = want + jnp.dot(tmp * sel, w_t[i], preferred_element_type=jnp.float32)
    for splits in _splits(down, cin, cout):
        _close(_plain(g, down, w, up8.shape[0], splits), np.asarray(want))


@pytest.mark.parametrize("cin, cout", WIDTHS)
def test_down_conv_cpu_gradients_match_the_jax_vjp(down_map, cin, cout):
    """``DownConv`` on the CPU (the list pass's and the dX's plain versions,
    K3's twin) against ``down_gather_conv``'s VJP, f32: dX to 1e-5 and dW
    (a sum over every row) to 1e-4 of the largest value."""
    import jax
    import jax.numpy as jnp

    from instancerefer_tpu.ops.sparse import down_gather_conv

    down, up_row, up_k, up8 = down_map
    g, w = _inputs(down, cin, cout)
    x = np.random.default_rng(cin).normal(size=(up8.shape[0], cin)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, k: down_gather_conv(
        f, jnp.asarray(down), jnp.asarray(up_row), jnp.asarray(up_k), k),
        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    sparse_conv.down_conv(xt, torch.from_numpy(down), torch.from_numpy(up8), wt).backward(
        torch.from_numpy(g))
    _close(xt.grad.numpy(), want_dx)
    _close(wt.grad.numpy(), want_dw, 1e-4)


@pytest.fixture(scope="module")
def bench_downs():
    """The 8 down maps of ``scripts/bench.py``'s synthetic batch of 64 at
    the fitted caps, with their ``up8``."""
    from instancerefer_tpu_torch.config import band_profile_kwargs
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.scripts import bench, step_ab

    caps = band_profile_kwargs(bench.PROFILE)
    spec = BatchSpec(**{k: caps[k] for k in ("scene_caps", "inst_caps", "max_candidates",
                                            "max_instances")})
    batch = make_batch(64, spec, seed=0, mean_size_arr=bench.MEAN_SIZE, **bench.SCENE_KW)
    return [(step_ab.shape_map(batch, f"{p}_down_{s}"), step_ab.shape_map(batch, f"{p}_up8_{s}"))
            for p in ("scene", "inst") for s in range(1, 5)]


def test_bench_down_maps_name_each_input_row_once(bench_downs):
    """At B = 64 each input row has at most one (row, offset) in its down
    map, and ``up8`` is that map inverted: so every dX row has one writer,
    and the rows no entry names are 0 in the list form."""
    for (down, up8), (v_out, v_in, cin, cout) in zip(bench_downs, BENCH_DOWNS):
        assert down.shape == (v_out, 8) and up8.shape == (v_in, 8)
        named = down[down >= 0]
        assert len(np.unique(named)) == len(named)
        assert ((up8 >= 0).sum(1) <= 1).all() and (up8 >= 0).sum() == len(named)
        rows, ks = np.nonzero(up8 >= 0)
        assert (down[up8[rows, ks], ks] == rows).all()
    down, up8 = bench_downs[-1]  # instance stage 4: 16384 rows of 128 channels
    gen = torch.Generator().manual_seed(0)
    g, w = torch.randn(down.shape[0], 128, generator=gen), torch.randn(8, 128, 128, generator=gen)
    nt = torch.from_numpy(down)
    dx = conv_bwd.down_dx(g, nt, torch.from_numpy(up8), w, conv_bwd.down_lists(nt))
    uncovered = torch.from_numpy((up8 < 0).all(1))
    assert uncovered.any() and (dx[uncovered] == 0).all() and (dx[~uncovered] != 0).any(1).all()


@pytest.mark.parametrize("v_out, v_in, cin, cout", BENCH_DOWNS + ((1000, 4000, 32, 32),
                                                                  (1, 8, 128, 32)))
def test_splits_are_a_function_of_the_shape(v_out, v_in, cin, cout):
    """The list-driven dX's blocks a list fill the card's slots at most and
    take at least ``LIST_SPLIT_ROWS`` map rows each; a shape and a card give
    one plan; its shared memory lets 2 to 4 blocks share an SM."""
    splits = conv_bwd.dx_list_splits(v_out, 8, cin, cout, H100_SMS)
    assert splits == conv_bwd.dx_list_splits(v_out, 8, cin, cout, H100_SMS)
    assert 1 <= splits <= max(1, -(-v_out // conv_bwd.LIST_SPLIT_ROWS))
    assert splits * 8 <= conv_bwd.dx_list_blocks(cin, cout) * H100_SMS
    assert conv_bwd.dx_list_splits(v_out, 8, cin, cout, 66) <= splits
    assert 2 <= conv_bwd.dx_list_blocks(cin, cout) <= 4
    assert conv_bwd.dx_list_smem_bytes(cin, cout) <= G.SMEM_LIMIT
    with pytest.raises(ValueError):
        conv_bwd.dx_list_splits(0, 8, cin, cout, H100_SMS)


def _fake_card(monkeypatch, calls):
    """The card's route with the C entries faked: each call recorded."""
    def entry(source, name, n_args, n_ints=5, n_longs=1):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(conv_bwd, "route", lambda dtype, cin, device: "tensor_core")
    monkeypatch.setattr(sparse_conv, "route", lambda dtype, cin, device: "tensor_core")
    monkeypatch.setattr(conv_bwd, "_entry", entry)
    monkeypatch.setattr(conv_bwd, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(conv_bwd, "sm_count", lambda device: H100_SMS)


def _counters():
    return (G.gather_conv.launches, conv_bwd.conv_dw.launches, conv_bwd.dw_lists.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_down_backward_runs_one_list_pass_for_both_gradients(monkeypatch, dtype):
    """On the card's route ``DownConv.backward`` runs the list pass once
    (``down_lists``: ``ir_dw_lists``), then ``ir_down_dx_tc`` and K3's
    ``ir_conv_dw_tc_lists`` over the same workspace: one list pass, one K1
    and one K3 launch; ``down_dx`` gets W as stored, the splits of
    ``dx_list_splits`` and a dX of the input's rows in the input's dtype
    (an f32 input's stored in f32, unrounded; a bf16 input's in bf16).  On
    the CPU with the entries faked."""
    calls = []
    _fake_card(monkeypatch, calls)

    def down_lists(nbr):
        work = conv_bwd.down_lists(nbr)
        calls.append(("down_lists", (nbr.data_ptr(), work.data_ptr())))
        return work

    monkeypatch.setattr(sparse_conv, "down_lists", down_lists)
    v_out, v_in, cin, cout = 3000, 9000, 64, 128
    down = torch.full((v_out, 8), -1, dtype=torch.int32)
    up8 = torch.full((v_in, 8), -1, dtype=torch.int32)
    x = torch.zeros(v_in, cin, dtype=dtype, requires_grad=True)
    w = torch.zeros(8, cin, cout, requires_grad=True)
    precision.set_compute_dtype("bfloat16")  # the main path's policy: casts inside
    try:
        out = sparse_conv.down_conv(x, down, up8, w)
        before = _counters()
        out.float().backward(torch.ones(v_out, cout))
    finally:
        precision.set_compute_dtype(None)
    assert _counters() == (before[0] + 1, before[1] + 1, before[2] + 1)
    names = [name for name, _ in calls]
    assert names == ["ir_dw_lists", "down_lists", "ir_down_dx_tc", "ir_conv_dw_tc_lists"]
    work = calls[1][1][1]
    assert calls[0][1][:2] == (down.data_ptr(), work)
    dx_args, dw_args = calls[2][1], calls[3][1]
    assert dx_args[1] == dw_args[1] == down.data_ptr() and dx_args[2] == up8.data_ptr()
    assert dx_args[4] == dw_args[3] == work
    splits = conv_bwd.dx_list_splits(v_out, 8, cin, cout, H100_SMS)
    assert dx_args[6:13] == (v_out, v_in, 8, cin, cout, splits, int(dtype == torch.float32))
    assert x.grad.shape == (v_in, cin) and w.grad.shape == (8, cin, cout)
    assert x.grad.dtype == dtype


def test_k3_alone_still_runs_its_own_list_pass(monkeypatch):
    """``conv_dw`` given no lists runs the list pass (``ir_dw_lists``, one
    list pass counted) and then ``ir_conv_dw_tc_lists`` over its
    workspace; given a workspace, ``ir_conv_dw_tc_lists`` and no list
    pass; a workspace of another map's size raises.  The list pass
    (``down_lists``) on the CPU is ``dw_lists_plain`` in the workspace's
    layout."""
    x = torch.zeros(900, 32, dtype=torch.bfloat16)
    nbr = torch.full((400, 8), -1, dtype=torch.int32)
    g = torch.zeros(400, 64, dtype=torch.bfloat16)
    work = conv_bwd.down_lists(nbr)
    lists, counts = conv_bwd.list_view(work, 400)
    assert not counts.any() and (lists == -1).all()
    assert work.numel() == conv_bwd.dw_list_workspace(400)
    calls = []
    _fake_card(monkeypatch, calls)
    before = _counters()
    conv_bwd.conv_dw(x, nbr, g)
    conv_bwd.conv_dw(x, nbr, g, lists=work)
    assert [name for name, _ in calls] == ["ir_dw_lists", "ir_conv_dw_tc_lists",
                                           "ir_conv_dw_tc_lists"]
    assert calls[0][1][1] == calls[1][1][3] != work.data_ptr()  # its own workspace
    assert calls[2][1][3] == work.data_ptr()
    assert _counters() == (before[0], before[1] + 2, before[2] + 1)
    with pytest.raises(ValueError, match="workspace"):
        conv_bwd.conv_dw(x, nbr, g, lists=work[1:])


@pytest.mark.parametrize("bad", ["f32", "width", "k", "g_rows", "workspace"])
def test_down_dx_refuses_what_the_kernel_does_not_take(monkeypatch, bad):
    """On the card's route: f32 (the FMA route keeps K1 over ``up8``), a
    width outside the kernels' (40), a map of other than 8 offsets, g of another
    row count, a workspace of another map's size."""
    calls = []
    _fake_card(monkeypatch, calls)
    monkeypatch.setattr(conv_bwd, "route", lambda dtype, cin, device: G.route(dtype, cin, "cuda"))
    v_out, v_in, cin, cout = 200, 700, 32, 64
    g = torch.zeros(v_out, cout, dtype=torch.bfloat16)
    down = torch.full((v_out, 8), -1, dtype=torch.int32)
    up8 = torch.full((v_in, 8), -1, dtype=torch.int32)
    w = torch.zeros(8, cin, cout, dtype=torch.bfloat16)
    work = torch.zeros(conv_bwd.dw_list_workspace(v_out), dtype=torch.int32)
    if bad == "f32":
        g, w = g.float(), w.float()
    elif bad == "width":
        w = torch.zeros(8, 40, cout, dtype=torch.bfloat16)
    elif bad == "k":
        down, w = torch.full((v_out, 27), -1, dtype=torch.int32), torch.zeros(27, cin, cout,
                                                                            dtype=torch.bfloat16)
    elif bad == "g_rows":
        g = torch.zeros(v_out + 1, cout, dtype=torch.bfloat16)
    else:
        work = work[:-1]
    with pytest.raises((TypeError, ValueError)):
        conv_bwd.down_dx(g, down, up8, w, work)
    assert not calls


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_down(gen, v_out, v_in, dev, fill=0.9):
    """A random down map on the card: ``fill`` of the ``v_in`` input rows
    each at a distinct (row, offset) of ``v_out`` x 8 (at most one entry an
    input row, as a stride-2 map), the rest named by none; and its up8."""
    n = min(int(fill * v_in), v_out * 8)
    slots = torch.randperm(v_out * 8, generator=gen, device=dev)[:n]
    rows = torch.randperm(v_in, generator=gen, device=dev)[:n].int()
    down = torch.full((v_out * 8,), -1, dtype=torch.int32, device=dev)
    down[slots] = rows
    up8 = torch.full((v_in, 8), -1, dtype=torch.int32, device=dev)
    up8[rows.long(), slots % 8] = (slots // 8).int()
    return down.view(v_out, 8), up8


@pytest.mark.gpu
@pytest.mark.parametrize("v_out, v_in, cin, cout", BENCH_DOWNS)
def test_down_dx_matches_plain_on_card(v_out, v_in, cin, cout):
    """The kernel at the 8 down shapes of a train step at B = 64, bf16 in
    and out, against its plain version on the same lists (within 1e-5 of
    the largest value before the store's one rounding: one product a row,
    summed in another order), its f32 store (an f32 input's) rounded to
    bf16 equal to it, two launches bit-identical, the rows no entry names
    exactly 0, one K1 launch a call."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(v_out + cin)
    down, up8 = _card_down(gen, v_out, v_in, dev)
    g = torch.randn(v_out, cout, device=dev, generator=gen).bfloat16()
    w = (torch.randn(8, cin, cout, device=dev, generator=gen) / (8 * cin) ** 0.5).bfloat16()
    work = conv_bwd.down_lists(down)
    before = G.gather_conv.launches
    dx = conv_bwd.down_dx(g, down, up8, w, work)
    again = conv_bwd.down_dx(g, down, up8, w, work)
    assert G.gather_conv.launches == before + 2
    splits = conv_bwd.dx_list_splits(v_out, 8, cin, cout, G.sm_count(dev))
    ref = conv_bwd.down_dx_plain(g, down, w, *conv_bwd.dw_lists_plain(down), v_in, splits)
    dx32 = conv_bwd.down_dx(g, down, up8, w, work, torch.float32)
    torch.cuda.synchronize()
    assert dx.dtype == g.dtype and dx.shape == (v_in, cin)
    err = rounding_gap(dx, ref).max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    assert torch.equal(dx, again)
    assert dx32.dtype == torch.float32 and torch.equal(dx32.bfloat16(), dx)
    assert (dx32 - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    uncovered = (up8 < 0).all(1)
    assert uncovered.any() and not dx[uncovered].any()


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(G.TC_WIDTHS, G.TC_WIDTHS)))
def test_down_dx_every_width_and_edge_on_card(cin, cout):
    """Every width pair the entry is built for, on a map with an empty
    offset and runs of empty rows, a map with no valid entry (all of dX
    0), and one row; K3 over the shared lists bit-identical to K3 with its
    own list pass."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout)
    for v_out, v_in in ((1000, 3000), (1, 8), (5000, 40000)):
        down, up8 = _card_down(gen, v_out, v_in, dev, fill=0.5)
        if v_out > 200:  # offset 5 and the first 150 rows emptied, in up8 too
            drop = torch.zeros_like(down, dtype=torch.bool)
            drop[:, 5] = True
            drop[:150] = True
            up8[down[drop & (down >= 0)].long()] = -1
            down[drop] = -1
        g = torch.randn(v_out, cout, device=dev, generator=gen).bfloat16()
        w = torch.randn(8, cin, cout, device=dev, generator=gen).bfloat16()
        x = torch.randn(v_in, cin, device=dev, generator=gen).bfloat16()
        work = conv_bwd.down_lists(down)
        dx = conv_bwd.down_dx(g, down, up8, w, work)
        ref = conv_bwd.down_dx_plain(g, down, w, *conv_bwd.dw_lists_plain(down), v_in)
        err = rounding_gap(dx, ref).max().item()
        assert dx.dtype == g.dtype and err <= 1e-5 * max(ref.abs().max().item(), 1e-30), \
            (v_out, err)
        assert not dx[(up8 < 0).all(1)].any()
        assert torch.equal(conv_bwd.conv_dw(x, down, g, lists=work), conv_bwd.conv_dw(x, down, g))
    none = torch.full((700, 8), -1, dtype=torch.int32, device=dev)
    g = torch.randn(700, cout, device=dev, generator=gen).bfloat16()
    dx = conv_bwd.down_dx(g, none, torch.full((900, 8), -1, dtype=torch.int32, device=dev),
                          torch.randn(8, cin, cout, device=dev, generator=gen).bfloat16(),
                          conv_bwd.down_lists(none))
    torch.cuda.synchronize()
    assert dx.shape == (900, cin) and not dx.any()


@pytest.mark.gpu
def test_down_dx_smem_matches_the_build_on_card():
    """The host's shared memory a block equals the library's."""
    import ctypes

    _card()
    fn = G.library("gather_conv").ir_dx_list_smem_bytes
    fn.restype = ctypes.c_longlong
    for cin, cout in itertools.product(G.TC_WIDTHS, G.TC_WIDTHS):
        assert fn(cin, cout) == conv_bwd.dx_list_smem_bytes(cin, cout)


def test_conv_bytes_counts_what_the_list_dx_moves(down_map):
    """``scripts/conv_bytes.list_dx_bytes``: the valid entries' g rows, W
    once a block, the list and map entries, ``up8`` once and the bf16 dX
    once, beside what K1's grid of tiles over ``up8`` staged (more)."""
    from instancerefer_tpu_torch.scripts import conv_bytes

    down, _, _, up8 = down_map
    nnz = int((down >= 0).sum())
    b = conv_bytes.list_dx_bytes(down, up8, 32, 64, 5)
    assert b == {"rows": nnz * 64 * 2, "w": 8 * 5 * 32 * 64 * 2, "index": nnz * 36,
                 "up8": up8.nbytes, "dx": up8.shape[0] * 32 * 2, "grid": b["grid"]}
    assert b["grid"] > b["rows"] + b["w"]
