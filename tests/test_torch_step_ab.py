"""The train-step A/B script: its run order, and its refusal without a card."""

import os
import subprocess
import sys

import pytest

from instancerefer_tpu_torch.scripts import step_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rounds_alternate_the_roots():
    assert step_ab._order(["p", "c"], 2) == ["p", "c", "c", "p", "p", "c", "c", "p"]
    assert step_ab._order(["p", "x", "c"], 1) == ["p", "x", "c", "c", "x", "p"]


def test_a_run_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, step_ab.__file__, "--child", "--steps", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert step_ab.PREFIX not in proc.stdout


def test_kernel_shapes_cover_the_stem_widths(monkeypatch):
    """The stems at Cin 7, 10 and 135 (K1 and K3 each, both encoders), fed
    the rows their main path gives them, K3 at every down conv (the list
    pass, then the dW kernel), and K1 at every tensor-core shape (down,
    residual, the down's dX over its lists, their pass outside the timing)
    and K2 at every residual.  On the CPU with the card's routes and the C
    entries faked: which entry each shape launches."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    labels = [s[0] for s in step_ab.SHAPES]
    for enc in ("scene", "instance"):
        for k in ("K1", "K3"):
            assert {f"{k} {enc} stem", f"{k} {enc} stem Cin 10",
                    f"{k} {enc} stem Cin 135"} <= set(labels)
    calls = []

    def entry(*key):
        name = next(k for k in key if str(k).startswith("ir_"))
        return lambda *args: calls.append(name) or 0

    route = G.route
    for module in (G, conv_bwd):
        monkeypatch.setattr(module, "_entry", entry)
        monkeypatch.setattr(module, "cuda_stream", lambda t: 0)
        monkeypatch.setattr(module, "route", lambda dtype, cin, device: route(dtype, cin, "cuda"))
    for module in (G, conv_bwd):
        monkeypatch.setattr(module, "sm_count", lambda device: 132)
    batch = make_batch(2, TEST_SPEC, seed=0, mean_size_arr=np.asarray(cs.MEAN_SIZE))

    def median_ms(fn):
        fn()
        return 0.0

    out = step_ab._time_kernels(batch, torch.device("cpu"), median_ms)
    assert list(out) == labels
    stems = ["ir_gather_conv_stem_wide", "ir_conv_dw_stem_wide"] * len(step_ab.STEM_CINS)
    # the down, the residual, the down's dX over its lists, K2
    tensor_core = ["ir_gather_conv_tc"] * 2 + ["ir_dw_lists", "ir_down_dx_tc",
                                               "ir_subm_conv_bwd_tc"]
    downs = ["ir_dw_lists", "ir_conv_dw_tc_lists"] * 4
    assert calls == (stems + downs) * 2 + tensor_core * 8


def test_plan_sweep_forces_each_plan_and_restores(monkeypatch):
    """``--plans``' forcing: inside ``forced_plans`` every K1 tensor-core and
    K2 launch of ``tc_labels`` hands the forced tile plan (and K2 the scaled
    dW splits) to the C entries; after it the plan functions are the
    package's again.  On the CPU with the card's routes and the C entries
    faked; ``--plans`` itself needs a card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    calls = []

    def entry(*key):
        name = next(k for k in key if str(k).startswith("ir_"))
        return lambda *args: calls.append((name, list(args[-5:-1]))) or 0

    route = G.route
    for module in (G, conv_bwd):
        monkeypatch.setattr(module, "_entry", entry)
        monkeypatch.setattr(module, "cuda_stream", lambda t: 0)
        monkeypatch.setattr(module, "route", lambda dtype, cin, device: route(dtype, cin, "cuda"))
        monkeypatch.setattr(module, "sm_count", lambda device: 132)
    batch = make_batch(2, TEST_SPEC, seed=0, mean_size_arr=np.asarray(cs.MEAN_SIZE))
    labels = step_ab.tc_labels(G.TC_WIDTHS)
    assert len(labels) == 24 and all(lab.split()[0] in ("K1", "K2") for lab in labels)
    assert not any("dX" in lab for lab in labels)  # the downs' dX runs over lists
    plans = (G.tc_plan, conv_bwd.tc_plan, conv_bwd.dw_plan)
    dw = [conv_bwd.dw_plan(2 * 8, 27, 64, 64, 132).splits]

    def timer(fn):
        fn()
        return 0.0

    with step_ab.forced_plans(tile=(64, 4), dw_scale=3):
        out = step_ab._time_kernels(batch, torch.device("cpu"), timer, labels)
        dw.append(conv_bwd.dw_plan(2 * 8, 27, 64, 64, 132).splits)
    assert list(out) == labels
    assert (G.tc_plan, conv_bwd.tc_plan, conv_bwd.dw_plan) == plans
    assert dw[1] == min(3 * dw[0], conv_bwd.DW_PARTIAL_BYTES // (4 * 27 * 64 * 64))
    # (Cout, relu, tile rows, cluster) of K1; (splits, tile rows, cluster,
    # G) of K2
    assert {tuple(a[2:4]) for n, a in calls if n == "ir_gather_conv_tc"} == {(64, 4)}
    assert {tuple(a[1:3]) for n, a in calls if n == "ir_subm_conv_bwd_tc"} == {(64, 4)}
    assert len(calls) == 24
    with pytest.raises(SystemExit, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        step_ab.plan_sweep([2])


def test_plan_sweep_forces_the_list_splits_and_restores(monkeypatch):
    """``--plans``' forcing of the list splits: inside ``forced_plans`` every
    K3 launch at a down conv (``list_labels``) hands the C entry the scaled
    splits of ``dw_list_splits`` (within ``DW_PARTIAL_BYTES``), and every
    down's dX the scaled blocks a list of ``dx_list_splits``; after it the
    plan functions are the package's again.  On the CPU with the card's
    routes and the C entries faked."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from instancerefer_tpu_torch.data.synthetic import TEST_SPEC, make_batch
    from instancerefer_tpu_torch.ops import conv_bwd
    from instancerefer_tpu_torch.ops import gather_conv as G

    calls = []

    def entry(*key):
        name = next(k for k in key if str(k).startswith("ir_"))
        at = -3 if name == "ir_down_dx_tc" else -2  # the splits, before the dX's store type
        return lambda *args: calls.append((name, args[at])) or 0

    route = G.route
    monkeypatch.setattr(conv_bwd, "_entry", entry)
    monkeypatch.setattr(conv_bwd, "cuda_stream", lambda t: 0)
    monkeypatch.setattr(conv_bwd, "route", lambda dtype, cin, device: route(dtype, cin, "cuda"))
    monkeypatch.setattr(conv_bwd, "sm_count", lambda device: 132)
    batch = make_batch(2, TEST_SPEC, seed=0, mean_size_arr=np.asarray(cs.MEAN_SIZE))
    labels = step_ab.list_labels(G.TC_WIDTHS)
    assert len(labels) == 16 and all("down" in lab for lab in labels)
    picked, picked_dx = conv_bwd.dw_list_splits, conv_bwd.dx_list_splits

    def timer(fn):
        fn()
        return 0.0

    for scale in (0.25, 4):
        calls.clear()
        with step_ab.forced_plans(list_scale=scale):
            out = step_ab._time_kernels(batch, torch.device("cpu"), timer, labels)
        # a list pass for each label (K3's own, the dX's outside the timing)
        assert [name for name, _ in calls[::2]] == ["ir_dw_lists"] * 16
        assert list(out) == labels and len(calls) == 32
        for (name, splits), label in zip(calls[1::2], labels):
            _, wrapper, key, in_key, cin, cout = next(s for s in step_ab.SHAPES if s[0] == label)
            if wrapper == "gather_conv_dx":  # the down map's rows, its Cin -> Cout
                v = batch[in_key].shape[0]
                assert name == "ir_down_dx_tc"
                assert splits == max(1, int(scale * picked_dx(v, 8, cout, cin, 132)))
                continue
            v = step_ab.shape_map(batch, key).shape[0]
            cap = conv_bwd.DW_PARTIAL_BYTES // (4 * 8 * cin * cout)
            assert name == "ir_conv_dw_tc_lists"
            assert splits == max(1, min(int(scale * picked(v, 8, cin, cout, 132)), cap))
    assert conv_bwd.dw_list_splits is picked and conv_bwd.dx_list_splits is picked_dx
