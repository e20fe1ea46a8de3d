"""PointGroup on the port (``models/pointgroup``, ``data/pointgroup``,
``train/pointgroup``) against the benchmark's plain reference
``benchmark/reference/pointgroup.py`` on the CPU, at a small size: two
synthetic rooms (``data/synthetic_scans.make_scan``) of a few hundred
points, all seven levels, m = 16, seeded random weights loaded into both.

Both run in f32 with their sums in other orders (the port's twins gather
and add per offset as the reference does, its BN sums x and x^2 where the
reference subtracts the mean first): the loss within 1e-5 of the
reference's, each parameter's gradient and each running statistic within
1e-4 of the larger of the leaf's largest value and the median leaf's (a
leaf far under the median holds nought but round-off: a shift the next BN
normalizes away).  The inverse conv alone
(``ops/sparse_conv.inverse_conv``) against the reference's, written from
its definition, forward and backward.
"""

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.data import pointgroup as D
from instancerefer_tpu_torch.data.synthetic_scans import make_scan
from instancerefer_tpu_torch.models.pointgroup import PointGroup
from instancerefer_tpu_torch.ops import conv_bwd, sparse_conv
from instancerefer_tpu_torch.train import pointgroup as T
from instancerefer_tpu_torch.train.solver import make_optimizer
from benchmark.reference import pointgroup as R

CFG = {"m": 16, "num_levels": 7, "block_reps": 2, "sem_classes": 20, "bn_eps": 1e-4,
       "lr": 1e-3, "wd": 1e-4}
SPEC = D.PGSpec((512, 512, 512, 512, 384, 256, 128), 576)


def _scenes(seed=0, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xyz, rgb, _, _, vobj, objects = make_scan(rng, 560, 300, 4)
        sem = np.array([objects[o][1] if o >= 0 else 0 for o in vobj])
        keep = rng.random(len(xyz)) > 0.05  # a few points of no class and no instance
        sem = np.where(keep, sem, 0)
        out.append({"xyz": xyz, "rgb": rgb, "sem": sem, "ins": np.where((vobj >= 0) & keep,
                                                                       vobj + 1, 0)})
    return out


@pytest.fixture(scope="module")
def pair():
    scenes = _scenes()
    samples = [D.pad_sample(D.scene_arrays(s["xyz"], s["rgb"], s["sem"], s["ins"]), SPEC)
               for s in scenes]
    batch = D.collate(samples, SPEC)
    assert not batch["level_overflow"].any() and not batch["point_overflow"].any()
    dd = SPEC.finish(SPEC.stage(batch))
    ref = R.prepare(scenes, 50.0, 7)
    state = R.init_state(R.PointGroup(), 11)
    return dd, ref, state


def _close(got, want, tol, what, floor=1e-12):
    got, want = got.double(), want.double()
    scale = max(want.abs().max().item(), floor)
    assert (got - want).abs().max().item() <= tol * scale, what


def _floor(leaves):
    """The median leaf's largest value: a leaf far under it (a shift that
    the next BN normalizes away) holds nought but round-off, so its error
    is measured against the median leaf's size, as the benchmark's check
    measures a leaf's gap."""
    tops = sorted(t.abs().max().item() for t in leaves)
    return tops[len(tops) // 2]


def test_levels_match_the_reference(pair):
    dd, ref, _ = pair
    for s, (sv, lv) in enumerate(zip(dd["pyramid"], ref["levels"])):
        assert int(sv.mask.sum()) == len(lv["coords"]), s
        # the same voxels, in the same order, sample by sample
        b = sv.owner[sv.mask]
        mine = sv.coords[sv.mask].long()
        assert torch.equal(b, lv["batch"]) and torch.equal(mine, lv["coords"]), s
        assert int((sv.nbr3[sv.mask] >= 0).sum()) == int((lv["nbr"] >= 0).sum()), s
    assert all(len(lv["coords"]) > 0 for lv in ref["levels"])


def test_forward_loss_gradients_and_statistics_match(pair):
    dd, ref, state = pair
    model = PointGroup()
    model.load_state_dict(state)
    model.train()
    out = model(dd)
    parts = T.pg.loss(out, dd)
    parts["loss"].backward()
    want = R.forward_loss(state, ref, CFG)
    assert abs(float(parts["loss"].detach()) - want["loss"]) <= 1e-5 * abs(want["loss"])
    floor = _floor(want["grad"].values())
    for n, p in model.named_parameters():
        _close(p.grad, want["grad"][n], 1e-4, n, floor)
    stats = {n: b for n, b in model.named_buffers() if "running" in n}
    assert stats.keys() == want["stats"].keys()
    for n, b in stats.items():
        _close(b, want["stats"][n], 1e-4, n)


def test_adam_steps_match(pair):
    """Two train steps through ``train_step`` (Adam with weight decay)
    against the reference's from the same state: each step's loss within
    1e-4, and each leaf's change in L2 within 0.1 of the larger of its own
    and the median leaf's.  Adam's first steps are nearly the gradient's
    sign, so the elements whose gradient is round-off step either way: a
    few in ten thousand of them read as a few % of a leaf's change in L2."""
    dd, ref, state = pair
    model = PointGroup()
    model.load_state_dict(state)
    opt = make_optimizer(model.parameters(), CFG["lr"], CFG["wd"])
    losses = [float(T.train_step(model, opt, dd)[0]["loss"]) for _ in range(2)]
    want = R.train_steps(state, [ref, ref], CFG)
    for got, ref_loss in zip(losses, want["losses"]):
        assert abs(got - ref_loss) <= 1e-4 * abs(ref_loss)
    moved = {n: (want["params"][n] - state[n]).double() for n in want["params"]}
    norms = sorted(float(v.norm()) for v in moved.values())
    for n, p in model.named_parameters():
        err = float((p.detach().double() - state[n] - moved[n]).norm())
        assert err <= 0.1 * max(float(moved[n].norm()), norms[len(norms) // 2]), n


def test_inverse_conv_matches_its_definition():
    """``inverse_conv`` over a pyramid's down map against the reference's
    ``_Inverse`` (each fine row its parent's row times its offset's slice),
    forward and both gradients."""
    scenes = _scenes(seed=5, n=2)
    samples = [D.pad_sample(D.scene_arrays(s["xyz"], s["rgb"], s["sem"], s["ins"]), SPEC)
               for s in scenes]
    dd = SPEC.finish(SPEC.stage(D.collate(samples, SPEC)))
    ref = R.prepare(scenes, 50.0, 7)
    gen = torch.Generator().manual_seed(4)
    for s in (1, 3):
        fine, coarse = dd["pyramid"][s - 1], dd["pyramid"][s]
        lv = ref["levels"][s - 1]
        n_c, n_f = len(ref["levels"][s]["coords"]), len(lv["coords"])
        x = torch.randn(n_c, 48, generator=gen)
        w = torch.randn(8, 48, 32, generator=gen)
        gy = torch.randn(n_f, 32, generator=gen)
        # the port's padded rows: the samples' rows at their caps' offsets
        rows_c = torch.nonzero(coarse.mask)[:, 0]
        rows_f = torch.nonzero(fine.mask)[:, 0]
        xp = torch.zeros(coarse.mask.shape[0], 48).index_copy(0, rows_c, x).requires_grad_()
        wp = w.clone().requires_grad_()
        out = sparse_conv.inverse_conv(xp, coarse.down, coarse.up8, wp,
                                       conv_bwd.down_lists(coarse.down))
        gp = torch.zeros(out.shape).index_copy(0, rows_f, gy)
        out.backward(gp)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = R._Inverse.apply(xr, wr, lv["parent"], lv["child_k"], R.F32)
        want.backward(gy)
        _close(out[rows_f].detach(), want.detach(), 1e-5, "forward")
        assert not out[~fine.mask].any()
        _close(xp.grad[rows_c], xr.grad, 1e-5, "dX")
        _close(wp.grad, wr.grad, 1e-5, "dW")


class _EagerGraph:
    """A stand-in for a CUDA graph on the CPU: the capture keeps the body,
    a replay runs it."""

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        return self.fn()


def test_step_graphs_run_pointgroup(pair):
    """``StepGraphs`` with ``PointGroupTask``: a staged batch loaded,
    a warm-up step, a capture, then a replay; the same losses and
    parameters as the eager steps from the same state, one graph a phase,
    the spans of the U-Net on the way."""
    from instancerefer_tpu_torch.train.step_graph import StepGraphs

    _, _, state = pair
    scenes = _scenes()
    batch = D.collate([D.pad_sample(D.scene_arrays(s["xyz"], s["rgb"], s["sem"], s["ins"]),
                                    SPEC) for s in scenes], SPEC)
    runs = []
    for graphs in (True, False):
        model = PointGroup()
        model.load_state_dict(state)
        opt = make_optimizer(model.parameters(), CFG["lr"], CFG["wd"])
        losses = []
        if graphs:
            sg = StepGraphs(model, opt, torch.zeros(()), new_graph=_EagerGraph,
                            task=T.PointGroupTask())
            for _ in range(2):
                dd = sg.load(SPEC.stage(batch), SPEC, "train")
                losses.append(float(sg.train_step(dd)[0]["loss"]))
            assert (sg.captures, sg.replays) == (1, 1)
        else:
            dd = SPEC.finish(SPEC.stage(batch))
            with torch.profiler.profile() as prof:
                losses.append(float(T.train_step(model, opt, dd)[0]["loss"]))
            losses.append(float(T.train_step(model, opt, dd)[0]["loss"]))
        runs.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (lg, pg), (le, pe) = runs
    assert np.allclose(lg, le, rtol=1e-5)
    for n in pg:
        assert torch.allclose(pg[n], pe[n], atol=1e-6), n
    names = {ev.name for ev in prof.events()}
    assert {"ir.fwd.unet", "ir.unet.down", "ir.unet.up", "ir.unet.tail", "ir.fwd.heads",
            "ir.bn", "ir.loss", "ir.backward", "ir.adam"} <= names
