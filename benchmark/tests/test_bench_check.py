"""The check that decides ``correct``, on the CPU at the rehearsal's size:
a sound run passes each cell's limits; a run with the timed path broken
underneath fails them (each fault a cell can have: a train step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced; and two that
only a graph's replay can have: its inputs left as the capture's, a
train replay that leaves the optimizer's step out); and the
control, the reference in the program's place one precision below the
configuration's (float8 sparse convs), fails them.  On the card the same
readings at the cells' own sizes set the limits (``limits/``,
``calibrate.py``)."""

import contextlib
import json

import pytest
import torch

from benchmark import calibrate, check, run

CELLS = {"xyzrgbh-train-resident": "train", "multiview-train-resident": "train",
         "xyzrgbh-eval-resident": "eval"}
SEED = 2147483905


def _run(cell, capsys):
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.2",
                     "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@contextlib.contextmanager
def _fault(monkeypatch, fault):
    """Break the program underneath the harness."""
    from instancerefer_tpu_torch.models import attribute_module
    from instancerefer_tpu_torch.train import step_graph

    from benchmark import program

    if fault == "frozen":  # the optimizer's step leaves the state as it was
        real = program.system

        def frozen(*args, **kw):
            system = real(*args, **kw)
            if system.optimizer is not None:
                system.optimizer.step = lambda *a, **k: None
            return system
        monkeypatch.setattr(program, "system", frozen)
    elif fault == "half":  # the loss's mean over the first half of the batch
        real_loss = step_graph.get_loss

        def half(out, mean_size):
            out = dict(out)
            b = out["sample_valid"].shape[0]
            out["sample_valid"] = out["sample_valid"] & (torch.arange(b) < b // 2)
            return real_loss(out, mean_size)
        monkeypatch.setattr(step_graph, "get_loss", half)
    elif fault == "altered":  # sample 0's first attribute score, where it is made
        real_fwd = attribute_module.AttributeModule.forward

        def altered(self, data_dict):
            out = real_fwd(self, data_dict)
            bump = torch.zeros_like(out["attribute_scores"])
            bump[0, 0] = 1.0
            return dict(out, attribute_scores=out["attribute_scores"] + bump)
        monkeypatch.setattr(attribute_module.AttributeModule, "forward", altered)
    elif fault == "stale":  # a replay's inputs keep what the capture held
        real_finish = step_graph.finish

        def stale(staged, spec, out=None):
            return out if out is not None else real_finish(staged, spec)
        monkeypatch.setattr(step_graph, "finish", stale)
    elif fault == "replay_frozen":  # a replay runs the step without Adam's update
        real_replay = program.EagerGraph.replay

        def no_update(self):
            with monkeypatch.context() as m:
                m.setattr(torch.optim.Adam, "step", lambda *a, **k: None)
                return real_replay(self)
        monkeypatch.setattr(program.EagerGraph, "replay", no_update)
    yield


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys):
    result = _run(cell, capsys)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, p in CELLS.items()
                                        for f in ("frozen", "half", "altered", "stale",
                                                  "replay_frozen")
                                        if p == "train" or "frozen" not in f])
def test_broken_program_is_not_correct(cell, fault, monkeypatch, capsys):
    with _fault(monkeypatch, fault):
        result = _run(cell, capsys)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _, values, traffic, _, _, limits = run.cell_data(run.ROOT, cell, rehearse=True)
    numbers = calibrate.reference_readings(SEED, values, traffic, torch.device("cpu"),
                                           ["control"])["control"]
    assert not check.judge(dict(numbers, caps_exceeded=0.0), limits), numbers
