"""The port's staged feed (``instancerefer_tpu_torch/data/prefetch.py``,
``data/host.stage`` / ``finish``) on the CPU, where the producer thread
stages into plain host buffers and ``finish`` runs on the consumer.

* ``finish(stage(b))`` against ``batch_to_torch(b)``, the plain reference,
  bit for bit on every tensor (``up8`` included): new tensors, into a
  ``Buffers`` set shared by two language grids, and into ``out=``.
* ``DevicePrefetcher`` over a ``PaddedLoader`` on a ``tests/fake_scanrefer``
  root: the loader's batches in its order, none dropped or repeated, the
  short last one included; the overflow log of the synchronous path; the
  ``PredictedClassLoader``'s predictions made on the producer thread equal
  the synchronous ones; a producer exception raised at its batch; a break
  or an exception in the consumer leaves no producer and no loader pool.
* A 2-epoch ``Solver`` run writes the ``scalars.jsonl`` of the parent's
  synchronous feed (``batch_to_torch`` on the consumer thread).

The JAX package comes in only through ``tests/test_torch_host_pipeline.py``,
which holds the port's ``collate`` and loaders to it bit for bit.
"""

import contextlib
import dataclasses
import json
import os
import threading
import traceback

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.data import dataset, prefetch, synthetic
from instancerefer_tpu_torch.data.host import Buffers, _named_tensors, batch_to_torch, finish, stage
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train import solver as S

from fake_scanrefer import make_fake_root

SPEC = dataclasses.replace(synthetic.TEST_SPEC, lang_bucket=8)
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])


def assert_same_data(got: dict, want: dict):
    """The same keys in the same order, and every tensor equal in dtype,
    shape and bits (``_named_tensors``: the pyramids field by field)."""
    assert list(got) == list(want)
    got, want = dict(_named_tensors(got)), dict(_named_tensors(want))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def _batches():
    """Two batches of other language grids (24 and 16 under bucketing)."""
    out = [synthetic.make_batch(2, SPEC, seed=s, mean_size_arr=MEAN_SIZE) for s in (0, 1)]
    assert [b["lang_feat"].shape[1] for b in out] == [24, 16]
    return out


@pytest.mark.parametrize("into", ["new", "buffers", "out"])
def test_finish_of_stage_equals_batch_to_torch(into):
    """``new``: tensors over the batch's arrays; ``buffers``: both batches
    staged into one set, twice, in turn, so that two shapes share it;
    ``out``: finished into the tensors of an earlier batch's data dict."""
    batches = _batches()
    want = [batch_to_torch(b, SPEC, "cpu") for b in batches]
    if into == "new":
        for b, w in zip(batches, want):
            assert_same_data(finish(stage(b, SPEC), SPEC), w)
        return
    if into == "out":
        for b, w, other in zip(batches, want, (3, 2)):  # seeds of the same grids
            out = batch_to_torch(synthetic.make_batch(2, SPEC, seed=other, mean_size_arr=MEAN_SIZE),
                                 SPEC, "cpu")
            assert out["lang_feat"].shape == w["lang_feat"].shape
            assert finish(stage(b, SPEC), SPEC, out=out) is out
            assert_same_data(out, w)
        return
    pool = Buffers()
    for _ in range(2):
        for b, w in zip(batches, want):
            staged = stage(b, SPEC, pool)
            dd = finish(staged, SPEC)
            assert_same_data(dd, w)
            # the set is rewritten once finish has read it: nothing of dd lies in it
            for t in staged.values():
                t.fill_(3)
            assert_same_data(dd, w)
    grids = sorted(k[1] for k in pool.tensors if k[0] == "lang_feat")
    assert grids == [(2, 16, 300), (2, 24, 300)]
    assert sum(k[0] == "scene_nbr3_0" for k in pool.tensors) == 1


def test_stage_runs_the_map_checks():
    batch = _batches()[0]
    bad = dict(batch, inst_upk_2=batch["inst_upk_2"].copy())
    bad["inst_upk_2"][0] = 8
    with pytest.raises(ValueError, match="inst_upk_2 holds offset 8"):
        stage(bad, SPEC)
    bad = dict(batch, scene_uprow_1=batch["scene_uprow_1"].copy())
    bad["scene_uprow_1"][batch["scene_upk_1"] >= 0] = 10**6
    with pytest.raises(ValueError, match="scene_up8_1 holds row 1000000"):
        stage(bad, SPEC)
    with pytest.raises(ValueError, match="scene_up8_1 holds row 1000000"):
        batch_to_torch(bad, SPEC, "cpu")
    bad = dict(batch, scene_nbr3_2=batch["scene_nbr3_2"] + 10**6)
    with pytest.raises(ValueError, match="scene_nbr3_2 holds row"):
        stage(bad, SPEC)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr")
    make_fake_root(root, np.random.default_rng(0))
    return str(root)


def _dataset(root, split="train"):
    return dataset.ScannetReferenceDataset(
        dataset.get_scanrefer(root, split), split, data_root=root, num_points=500,
        use_augment=True, seed=7)


def _loader(root, **kw):
    # 4 a batch over 6 descriptions: the last batch holds two
    return dataset.PaddedLoader(_dataset(root), SPEC, 4, shuffle=True, seed=3, num_workers=2,
                                **kw)


def _pool_threads():
    return {t for t in threading.enumerate() if t.name.startswith("ThreadPoolExecutor")}


def test_prefetcher_yields_the_loaders_batches_in_order(fake_root):
    """Two epochs each way: the same batches in the same order (the short
    last one, 2 valid samples of 4, included), and the same overflow log
    as the synchronous path gathers."""
    want, want_log = [], {"scene": [], "inst": [], "cand": []}
    loader = _loader(fake_root)
    for _ in range(2):
        for b in loader:
            want.append(batch_to_torch(b, SPEC, "cpu"))
            want_log["scene"].append(float(b["scene_overflow"].mean()))
            want_log["inst"].append(float(b["inst_overflow"].mean()))
            want_log["cand"].append(float(b["cand_overflow"].mean()))
    assert len(want) == 4 and [int(w["sample_valid"].sum()) for w in want] == [4, 2, 4, 2]
    got, log = [], {"scene": [], "inst": []}
    loader = _loader(fake_root)
    for _ in range(2):
        with prefetch.DevicePrefetcher(loader, SPEC, "cpu", overflow_log=log) as batches:
            for ready in batches:
                with ready as staged:
                    got.append(finish(staged, SPEC))
                assert ready.stage > 0 and ready.load >= 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_data(g, w)
    assert log == want_log


class _Recording:
    """A ``predict_fn``: a fixed function of the descriptions, recording
    its calls and the thread that made them."""

    def __init__(self):
        self.calls, self.threads = [], set()

    def __call__(self, lang_feat, lang_len):
        self.threads.add(threading.current_thread().name)
        pred = (np.abs(lang_feat).sum(axis=(1, 2)) * 1e3).astype(np.int64) % SPEC.num_classes
        self.calls.append((lang_feat.copy(), np.asarray(lang_len).copy(), pred))
        return pred


def test_predicted_classes_on_the_producer_thread_equal_the_synchronous_ones(fake_root):
    runs = []
    for threaded in (False, True):
        fn = _Recording()
        pcl = dataset.PredictedClassLoader(_dataset(fake_root), SPEC, 4, fn, predict_batch=4,
                                           shuffle=True, seed=3, num_workers=2)
        if threaded:
            with prefetch.DevicePrefetcher(pcl, SPEC, "cpu") as batches:
                out = []
                for ready in batches:
                    with ready as staged:
                        out.append(finish(staged, SPEC))
        else:
            out = [batch_to_torch(b, SPEC, "cpu") for b in pcl]
        runs.append((fn, out))
    (sync_fn, sync), (thr_fn, thr) = runs
    assert sync_fn.threads == {threading.current_thread().name}
    assert thr_fn.threads == {"DevicePrefetcher"}
    assert len(sync_fn.calls) == len(thr_fn.calls) == 2
    for a, b in zip(sync_fn.calls, thr_fn.calls):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert len(sync) == len(thr) == 2
    for g, w in zip(thr, sync):
        assert_same_data(g, w)


def _failing(batches):
    yield from batches
    raise RuntimeError("the loader failed")


def test_a_producer_exception_is_raised_at_its_batch():
    batches = _batches()
    got = []
    with pytest.raises(RuntimeError, match="the loader failed") as err:
        with prefetch.DevicePrefetcher(_failing(batches), SPEC, "cpu") as fed:
            for ready in fed:
                with ready as staged:
                    got.append(finish(staged, SPEC))
    assert len(got) == 2
    assert "_failing" in [f.name for f in traceback.extract_tb(err.value.__traceback__)]
    assert not fed._thread.is_alive()


class _Closing:
    """A loader that records which thread ran its ``finally``."""

    def __init__(self, batches):
        self.batches, self.closed_by = batches, None

    def __iter__(self):
        try:
            while True:
                yield from self.batches
        finally:
            self.closed_by = threading.current_thread().name


@pytest.mark.parametrize("end", ["break", "raise"])
def test_leaving_early_stops_the_producer_and_the_loaders_pools(fake_root, end):
    """After batch 1: the producer joined, the loader's generator closed by
    it (its thread pools shut down), an endless loader too."""
    before = _pool_threads()
    for loader in (_loader(fake_root), _Closing(_batches())):
        with pytest.raises(KeyError) if end == "raise" else contextlib.nullcontext():
            with prefetch.DevicePrefetcher(loader, SPEC, "cpu") as fed:
                for ready in fed:
                    with ready as staged:
                        finish(staged, SPEC)
                    if end == "raise":
                        raise KeyError("a step failed")
                    break
        assert fed._thread is not None and not fed._thread.is_alive()
        assert _pool_threads() <= before
    assert loader.closed_by == "DevicePrefetcher"


def _solver_run(tmp_path, name, data):
    torch.manual_seed(0)
    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          dropout_override=0.0)
    torch.manual_seed(1)
    solver = S.Solver(model, MEAN_SIZE, SPEC, "cpu", stamp=name, output_dir=str(tmp_path),
                      lr_decay_step=[1], lr_decay_rate=0.1)
    solver(data, 2, verbose=1)
    with open(os.path.join(solver.root, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


class _SyncFeed:
    """The parent's feed: each batch through ``batch_to_torch`` on the
    consumer thread, handed to the solver as it is."""

    def __init__(self, loader, spec, device, overflow_log=None):
        self.loader, self.spec, self.device = loader, spec, device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __iter__(self):
        for batch in self.loader:
            ready = prefetch.Ready(None, None, batch_to_torch(batch, self.spec, self.device), 0.0)
            yield ready


def test_a_solver_run_writes_the_losses_of_the_synchronous_feed(tmp_path, monkeypatch):
    batches = _batches()
    data = {"train": [batches[0], batches[1]], "val": [batches[1]]}
    got = _solver_run(tmp_path, "prefetched", data)
    monkeypatch.setattr(S, "DevicePrefetcher", _SyncFeed)
    monkeypatch.setattr(S, "finish", lambda dd, spec: dd)
    want = _solver_run(tmp_path, "synchronous", data)
    assert [r["phase"] for r in got] == ["train", "train", "val"] * 2
    assert got == want
    assert got[0]["loss"] != got[3]["loss"]
