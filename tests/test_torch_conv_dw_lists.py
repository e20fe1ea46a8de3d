"""K3's tensor-core route at the down convs: the dW over per-offset lists of
the map's valid entries (``ops/conv_bwd.conv_dw``; ``csrc/conv_dw.cu``'s list
pass and ``csrc/sparse_conv_tc.cuh``'s ``dw_list_tc_kernel``).

* The list pass's plain version (``conv_bwd.dw_lists_plain``): each column's
  valid rows in ascending order, the counts, -1 past them.
* The dW summed over the lists in the kernel's order (each split's range of
  each list, ``dw_list_ranges`` under ``dw_list_splits``, then the splits in
  ``sum_partials_kernel``'s order), against the plain twin
  ``sparse.conv_dw`` and against the JAX package's ``windowed_conv_dw`` in
  interpret mode, on drop-free banded maps (where the banded kernel is
  exact).  f32 on every side, sums in another order: within 1e-5 of the
  largest value.
* The split plan, a function of the shape and the card's SM count alone.
* The wrapper hands the C entry the list workspace and counts the list pass.

The card tests (``@pytest.mark.gpu``) skip without a CUDA device.  JAX is
imported only inside the test that compares with it, so on a card this file
runs without the repo's conftest: ``python -m pytest
tests/test_torch_conv_dw_lists.py -m gpu --noconftest``.
"""

import itertools

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.ops import conv_bwd, sparse
from instancerefer_tpu_torch.ops import gather_conv as G

H100_SMS = 132
TOL = 1e-5  # of the largest value: f32 sums in another order
WIDTHS = ((32, 64), (64, 128), (128, 128))  # the downs' Cin -> Cout
SUM_RUNS = 8  # sum_partials_kernel's runs of consecutive splits (csrc/sparse_conv.cuh)


def _random_map(rng, v_out, v_in, k, fill):
    nbr = rng.integers(0, v_in, size=(v_out, k)).astype(np.int32)
    nbr[rng.random((v_out, k)) >= fill] = -1
    return nbr


def _check_lists(nbr):
    """``dw_lists_plain`` against a column-by-column reading of ``nbr``."""
    lists, counts = conv_bwd.dw_lists_plain(torch.from_numpy(nbr))
    v_out, k = nbr.shape
    assert lists.shape == (k, v_out) and lists.dtype == torch.int32
    assert counts.shape == (k,) and counts.dtype == torch.int32
    for j in range(k):
        rows = np.flatnonzero(nbr[:, j] >= 0)
        assert counts[j] == len(rows)
        np.testing.assert_array_equal(lists[j, :len(rows)].numpy(), rows)
        assert (lists[j, len(rows):] == -1).all()
    return lists, counts


@pytest.mark.parametrize("v_out", [1, 63, 65, 1000, 2049])
def test_plain_list_pass_orders_and_counts(v_out):
    """Ascending rows, the counts, rows not a multiple of 64 (nor of the
    pass's 1024-row chunks), an offset empty everywhere and one empty in
    part of the rows."""
    rng = np.random.default_rng(v_out)
    nbr = _random_map(rng, v_out, 700, 8, 0.3)
    nbr[:, 5] = -1
    nbr[: v_out // 2, 2] = -1
    lists, counts = _check_lists(nbr)
    assert counts[5] == 0 and (lists[5] == -1).all()


def test_plain_list_pass_of_an_empty_map():
    lists, counts = _check_lists(np.full((300, 8), -1, np.int32))
    assert not counts.any() and (lists == -1).all()
    lists, counts = _check_lists(np.zeros((0, 8), np.int32))
    assert lists.shape == (8, 0) and not counts.any()


def _sum_partials(partial):
    """``sum_partials_kernel``'s order: runs of ceil(S / 8) consecutive
    splits, each summed in ascending order, then the runs in order."""
    splits = partial.shape[0]
    per = -(-splits // SUM_RUNS)
    total = torch.zeros_like(partial[0])
    for q in range(SUM_RUNS):
        run = torch.zeros_like(partial[0])
        for s in range(q * per, min(splits, (q + 1) * per)):
            run = run + partial[s]
        total = total + run
    return total


def list_dw(feats, nbr, g, splits):
    """dW over the lists as the kernel sums it: block (k, s) adds
    x[nbr[v, k]]^T g[v] over range s of list k (``dw_list_ranges``) into
    partial[s, k], in tiles of ``DWL_BR`` entries, then the splits in the
    fixed order.  f32."""
    lists, counts = conv_bwd.dw_lists_plain(nbr)
    k, cin, cout = nbr.shape[1], feats.shape[1], g.shape[1]
    x, gf = feats.float(), g.float()
    partial = torch.zeros(splits, k, cin, cout)
    for j in range(k):
        for s, (p0, p1) in enumerate(conv_bwd.dw_list_ranges(int(counts[j]), splits)):
            for t0 in range(p0, p1, conv_bwd.DWL_BR):
                v = lists[j, t0:min(p1, t0 + conv_bwd.DWL_BR)].long()
                partial[s, j] += x[nbr[v, j].long()].T @ gf[v]
    return _sum_partials(partial)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


CAP0, CAP1 = 2048, 512
CHUNK, WINDOW, SUBWIN = 128, 512, 384


@pytest.fixture(scope="module")
def down_map():
    """A stage-1 ``down`` map (K = 8, rows of stage 0) of two
    raster-ordered scenes, flattened as collate does: one valid entry an
    input row at most, as the downs' maps."""
    from instancerefer_tpu.ops import voxelize as V

    rng = np.random.default_rng(0)
    down = []
    for b in range(2):
        pts = rng.uniform(0, 2.5, size=(2500, 3))
        coords, _ = V.quantize(pts, pts.astype(np.float32), 0.05, raster_order=True)
        pyr = V.build_pyramid(coords, owner=0, num_stages=2, caps=[CAP0, CAP1], raster=True)
        st = V.pad_stage(pyr[1], CAP1, CAP0)
        down.append(np.where(st.down >= 0, st.down + b * CAP0, -1))
    return np.concatenate(down).astype(np.int32), 2 * CAP0


@pytest.mark.parametrize("cin, cout", WIDTHS)
def test_list_dw_matches_twin_and_pallas(down_map, cin, cout):
    """The list-form dW in the kernel's split order (at the splits an H100
    takes for the shape, and at 7, ranges that end mid-tile) against
    ``sparse.conv_dw`` and the TPU kernel ``windowed_conv_dw`` in interpret
    mode; f32, within 1e-5 of the largest value."""
    import jax.numpy as jnp

    from instancerefer_tpu.ops import voxelize as V
    from instancerefer_tpu.ops.pallas_conv import windowed_conv_dw

    nbr, v_in = down_map
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(v_in, cin)).astype(np.float32)
    g = rng.normal(size=(nbr.shape[0], cout)).astype(np.float32)
    ws, wskt, dropped, total = V.compute_offset_window_starts(
        nbr, CHUNK, WINDOW, SUBWIN, v_in, count_drops=True)
    assert dropped == 0 and total == int((nbr >= 0).sum())
    want = np.asarray(windowed_conv_dw(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(g), jnp.asarray(ws), jnp.asarray(wskt),
        window=WINDOW, chunk=CHUNK, subwin=SUBWIN, interpret=True))[:, :cin, :cout]
    xt, nt, gt = (torch.from_numpy(a) for a in (x, nbr, g))
    twin = sparse.conv_dw(xt, nt, gt)
    _close(twin.numpy(), want)
    for splits in (conv_bwd.dw_list_splits(nbr.shape[0], 8, cin, cout, H100_SMS), 7):
        got = list_dw(xt, nt, gt, splits)
        _close(got.numpy(), twin.numpy())
        _close(got.numpy(), want)


def test_list_ranges_cover_each_list_in_whole_tiles():
    """Each split's range starts where the last ended, all of them cover the
    list, and every range but the last non-empty one is whole tiles."""
    for count, splits in itertools.product((0, 1, 63, 64, 65, 1000, 119154), (1, 2, 7, 49)):
        ranges = conv_bwd.dw_list_ranges(count, splits)
        assert len(ranges) == splits and ranges[0][0] == 0 and ranges[-1][1] == count
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0 and a0 <= a1
        full = [r for r in ranges if r[1] > r[0]]
        assert all((b - a) % conv_bwd.DWL_BR == 0 for a, b in full[:-1])
        assert all(b - a <= full[0][1] - full[0][0] for a, b in full)


# the eight downs of a train step at the bench's batch of 64: (V_out, Cin, Cout)
BENCH_DOWNS = ((278528, 32, 64), (81920, 64, 128), (32768, 128, 128), (16384, 128, 128),
               (114688, 32, 64), (81920, 64, 128), (32768, 128, 128), (16384, 128, 128))


@pytest.mark.parametrize("rows, cin, cout", BENCH_DOWNS + ((1000, 32, 32), (1, 128, 32)))
def test_split_plan_is_a_function_of_the_shape(rows, cin, cout):
    """Splits fill the card's block slots at most, take at least
    ``LIST_SPLIT_ROWS`` map rows each and keep the partials within
    ``DW_PARTIAL_BYTES``; a shape and a card give one plan."""
    splits = conv_bwd.dw_list_splits(rows, 8, cin, cout, H100_SMS)
    assert splits == conv_bwd.dw_list_splits(rows, 8, cin, cout, H100_SMS)
    assert 1 <= splits <= max(1, -(-rows // conv_bwd.LIST_SPLIT_ROWS))
    assert splits * 8 <= conv_bwd.dw_list_blocks(cin, cout) * H100_SMS
    assert splits * 8 * cin * cout * 4 <= conv_bwd.DW_PARTIAL_BYTES
    assert conv_bwd.dw_list_splits(rows, 8, cin, cout, 66) <= splits
    with pytest.raises(ValueError):
        conv_bwd.dw_list_splits(0, 8, cin, cout, H100_SMS)


@pytest.mark.parametrize("cin, cout", list(itertools.product(G.TC_WIDTHS, G.TC_WIDTHS)))
def test_list_kernel_shared_memory_fits_two_blocks(cin, cout):
    smem = conv_bwd.dw_list_smem_bytes(cin, cout)
    assert smem <= conv_bwd.DWL_SMEM_BUDGET and 2 <= conv_bwd.dw_list_blocks(cin, cout) <= 3
    assert smem // (conv_bwd.DWL_BR * (cin + cout + 2 * G.PAD) * 2 + 8 * conv_bwd.DWL_BR) >= 3


def test_wrapper_hands_the_entry_the_lists(monkeypatch):
    """On the tensor-core route, given no lists, the wrapper allocates the
    list workspace (``dw_list_workspace`` int32) and the partials of
    ``dw_list_splits``, launches the list pass (``ir_dw_lists``) into the
    workspace and then ``ir_conv_dw_tc_lists`` over it, and counts one K3
    and one list-pass launch; a map of other than 8 offsets raises.  On the
    CPU with the card's route and the C entries faked."""
    calls = []

    def entry(source, name, n_args, n_ints=5):
        return lambda *args: calls.append((name, n_args, args)) or 0

    monkeypatch.setattr(conv_bwd, "route", lambda dtype, cin, device: "tensor_core")
    monkeypatch.setattr(conv_bwd, "_entry", entry)
    monkeypatch.setattr(conv_bwd, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(conv_bwd, "sm_count", lambda device: H100_SMS)
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        allocated.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    v_out, k = 5000, 8
    x = torch.zeros(4000, 64, dtype=torch.bfloat16)
    nbr = torch.full((v_out, k), -1, dtype=torch.int32)
    g = torch.zeros(v_out, 128, dtype=torch.bfloat16)
    before = (conv_bwd.conv_dw.launches, conv_bwd.dw_lists.launches)
    conv_bwd.conv_dw(x, nbr, g)
    assert (conv_bwd.conv_dw.launches, conv_bwd.dw_lists.launches) == \
        (before[0] + 1, before[1] + 1)
    [(list_name, _, list_args), (name, n_args, args)] = calls
    assert list_name == "ir_dw_lists" and list_args[0] == nbr.data_ptr()
    assert list_args[2:4] == (v_out, k) and list_args[1] == args[3]  # the workspace
    splits = conv_bwd.dw_list_splits(v_out, k, 64, 128, H100_SMS)
    assert name == "ir_conv_dw_tc_lists" and n_args == 6
    assert args[6:11] == (v_out, k, 64, 128, splits)
    assert ((conv_bwd.dw_list_workspace(v_out),), torch.int32) in allocated
    assert ((splits, k, 64, 128), torch.float32) in allocated
    with pytest.raises(ValueError, match="K = 8"):
        conv_bwd.conv_dw(x, torch.full((v_out, 27), -1, dtype=torch.int32), g)


def test_workspace_layout():
    """lists [8, V_out], counts [8], each 1024-row chunk's counts [n, 8]."""
    assert conv_bwd.dw_list_workspace(1) == 8 * 3
    assert conv_bwd.dw_list_workspace(1024) == 8 * (1024 + 2)
    assert conv_bwd.dw_list_workspace(1025) == 8 * (1025 + 3)
    assert conv_bwd.dw_list_workspace(278528) * 4 < 9e6  # scene stage 1 at B = 64


def test_list_pass_on_the_cpu_is_the_plain_version():
    nbr = torch.from_numpy(_random_map(np.random.default_rng(3), 700, 500, 8, 0.4))
    for got, want in zip(conv_bwd.dw_lists(nbr), conv_bwd.dw_lists_plain(nbr)):
        assert torch.equal(got, want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_map(gen, v_out, v_in, k, dev):
    """Random indices, 30% valid, with runs of rows and a whole offset
    empty."""
    nbr = torch.randint(0, v_in, (v_out, k), generator=gen, device=dev, dtype=torch.int32)
    nbr[torch.rand(v_out, k, generator=gen, device=dev) >= 0.3] = -1
    nbr[64:200] = -1
    nbr[:, 5] = -1
    return nbr.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("v_out", [1, 1000, 1024, 2049, 5000, 70000, 278528])
def test_list_pass_matches_plain_on_card(v_out):
    """The list pass on the card equals its plain version in every entry:
    one row, a ragged last chunk, a whole chunk, many chunks, the scene's
    stage-1 down map at B = 64; another K raises."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(v_out)
    nbr = _card_map(gen, v_out, 900, 8, dev) if v_out > 200 else \
        torch.randint(-1, 5, (v_out, 8), generator=gen, device=dev, dtype=torch.int32)
    before = conv_bwd.dw_lists.launches
    lists, counts = conv_bwd.dw_lists(nbr)
    assert conv_bwd.dw_lists.launches == before + 1
    want_lists, want_counts = conv_bwd.dw_lists_plain(nbr)
    assert torch.equal(counts, want_counts) and torch.equal(lists, want_lists)
    empty = torch.full((300, 8), -1, dtype=torch.int32, device=dev)
    lists, counts = conv_bwd.dw_lists(empty)
    assert not counts.any() and (lists == -1).all()
    with pytest.raises(ValueError, match=r"not \[V, 8\]"):
        conv_bwd.dw_lists(torch.zeros(300, 27, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("cin, cout", list(itertools.product(G.TC_WIDTHS, G.TC_WIDTHS)))
@pytest.mark.parametrize("v_out", [1000, 40000])
def test_list_dw_matches_twin_on_card(cin, cout, v_out):
    """K3's list route against ``sparse.conv_dw`` (within 1e-4 of the
    largest value, as chip_smoke.py's DW_TOL: sums over every row), an
    empty offset's dW exactly zero, two launches bit-identical, and a map
    with no valid entry at all a zero dW."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(cin * cout + v_out)
    nbr = _card_map(gen, v_out, 900, 8, dev)
    x = torch.randn(900, cin, device=dev, generator=gen).bfloat16()
    g = torch.randn(v_out, cout, device=dev, generator=gen).bfloat16()
    assert G.route(x.dtype, cin, x.device) == "tensor_core"
    dw = conv_bwd.conv_dw(x, nbr, g)
    ref = sparse.conv_dw(x, nbr, g)
    err = (dw - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
    assert torch.equal(dw[5], torch.zeros_like(dw[5]))
    assert torch.equal(dw, conv_bwd.conv_dw(x, nbr, g))  # bit-identical
    none = torch.full_like(nbr, -1)
    assert torch.equal(conv_bwd.conv_dw(x, none, g), torch.zeros_like(dw))


@pytest.mark.gpu
def test_list_sizes_match_the_build_on_card():
    """The host's workspace and shared-memory sizes equal the library's."""
    import ctypes

    _card()
    lib = G.library("conv_dw")
    work, smem = lib.ir_dw_list_work_ints, lib.ir_dw_list_smem_bytes
    work.restype = smem.restype = ctypes.c_longlong
    work.argtypes = [ctypes.c_longlong]
    for v_out in (1, 1024, 1025, 278528):
        assert work(v_out) == conv_bwd.dw_list_workspace(v_out)
    for cin, cout in itertools.product(G.TC_WIDTHS, G.TC_WIDTHS):
        assert smem(cin, cout) == conv_bwd.dw_list_smem_bytes(cin, cout)
