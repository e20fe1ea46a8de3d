"""The train-step A/B script: its run order, and its refusal without a card."""

import os
import subprocess
import sys

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
    the rows their main path gives them, and K3 at every down conv.  On the
    CPU with the card's routes and the C entries faked: which entry each
    shape launches."""
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
    monkeypatch.setattr(conv_bwd, "sm_count", lambda device: 132)
    batch = make_batch(2, TEST_SPEC, seed=0, mean_size_arr=np.asarray(cs.MEAN_SIZE))

    def median_ms(fn):
        fn()
        return 0.0

    out = step_ab._time_kernels(batch, torch.device("cpu"), median_ms)
    assert list(out) == labels
    stems = ["ir_gather_conv_stem_wide", "ir_conv_dw_stem_wide"] * len(step_ab.STEM_CINS)
    assert calls == (stems + ["ir_conv_dw_tc"] * 4) * 2
