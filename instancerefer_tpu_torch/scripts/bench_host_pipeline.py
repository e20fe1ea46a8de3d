"""The host pipeline's bench: samples/s through ``PaddedLoader`` by worker
count, the per-sample phase split of ``pad_sample`` and the parallel
collate's fan-out, over the port's own pipeline (``data/pipeline.py``,
``ops/voxelize.py``, ``native/voxelizer.cpp``).  The counterpart of the JAX
package's ``scripts/bench_host_pipeline.py``; ``scripts/bench.py`` reports
``phase_split`` and ``median_ms`` from here.

    python -m instancerefer_tpu_torch.scripts.bench_host_pipeline \\
        [--samples 16] [--points 40000] [--batch_size 8] [--workers 0 1 2 4 8] \\
        [--collate-workers 1 2 4]

Runs on the CPU only.  Prints progress on stderr and one JSON line on
stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])


def median_ms(fn, reps: int = 7, warm: bool = True) -> float:
    """Median wall-clock ms of ``fn`` over ``reps`` calls, after one call
    outside the timing when ``warm``."""
    if warm:
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_split(core, spec, reps: int = 7) -> dict:
    """``pad_sample``'s phases for one sample, each the median over
    ``reps`` calls in ms (``{phase}_ms``), measured inside the real call
    through its ``timings`` hook; ``pad_sample_total_ms`` the median total
    and ``accounted_frac`` the named phases' sum over it (at most 1)."""
    from instancerefer_tpu_torch.data.pipeline import pad_sample

    pad_sample(core, spec)  # warm: allocator, the native library's load
    totals, phases = [], []
    for _ in range(reps):
        t: dict = {}
        t0 = time.perf_counter()
        pad_sample(core, spec, timings=t)
        totals.append((time.perf_counter() - t0) * 1e3)
        phases.append(t)
    keys = sorted({k for t in phases for k in t})
    out = {f"{k}_ms": float(np.median([t.get(k, 0.0) * 1e3 for t in phases])) for k in keys}
    total = float(np.median(totals))
    out["pad_sample_total_ms"] = total
    out["accounted_frac"] = round(sum(out[f"{k}_ms"] for k in keys) / total, 3) if total else 1.0
    return out


class _TimingPool:
    """A stand-in pool that runs each submitted job at once and sums its ms."""

    def __init__(self):
        self.job_ms = 0.0

    def submit(self, fn):
        t0 = time.perf_counter()
        result = fn()
        self.job_ms += (time.perf_counter() - t0) * 1e3

        class _Done:
            def result(self):
                return result

        return _Done()


def collate_scaling(cores, spec, batch_size: int, worker_counts, reps: int = 5) -> dict:
    """The parallel collate of one batch: ``serial_ms`` without a pool,
    ``pool{w}_ms`` with a thread pool of each worker count, and the split
    of a serial run into the jobs a pool can overlap (``pooled_jobs_ms``,
    the per-key copies that release the interpreter lock) and the rest
    (``serial_share_ms``, what no pool shortens)."""
    from concurrent.futures import ThreadPoolExecutor

    from instancerefer_tpu_torch.data.pipeline import collate, pad_sample

    padded = [pad_sample(c, spec) for c in cores[:batch_size]]
    while len(padded) < batch_size:
        padded.append(padded[-1])
    out = {"serial_ms": median_ms(lambda: collate(padded, spec), reps=reps)}
    pool = _TimingPool()
    t0 = time.perf_counter()
    collate(padded, spec, pool=pool)
    total = (time.perf_counter() - t0) * 1e3
    out["pooled_jobs_ms"] = round(pool.job_ms, 2)
    out["serial_share_ms"] = round(max(total - pool.job_ms, 0.0), 2)
    for w in worker_counts:
        with ThreadPoolExecutor(w) as tp:
            out[f"pool{w}_ms"] = median_ms(lambda: collate(padded, spec, pool=tp), reps=reps)
        print(f"[host-bench] collate pool={w}: {out[f'pool{w}_ms']:.1f} ms (serial "
              f"{out['serial_ms']:.1f} ms)", file=sys.stderr)
    print(f"[host-bench] collate: pooled jobs {out['pooled_jobs_ms']:.1f} ms, serial share "
          f"{out['serial_share_ms']:.1f} ms", file=sys.stderr)
    return out


class _Cores:
    """The dataset interface ``PaddedLoader`` reads, over prebuilt samples."""

    static_scene_sampling = False
    augment = False

    def __init__(self, cores):
        self.cores = cores

    def __len__(self):
        return len(self.cores)

    def lang_lengths(self):
        return np.array([c.lang_len for c in self.cores])

    def get_core(self, idx, rng=None, class_override=None):
        return self.cores[idx]


def loader_scaling(cores, spec, batch_size: int, worker_counts) -> dict:
    """Samples/s through ``PaddedLoader`` over ``cores``, by worker count."""
    from instancerefer_tpu_torch.data.dataset import PaddedLoader

    ds = _Cores(cores)
    results = {}
    for w in worker_counts:
        loader = PaddedLoader(ds, spec, batch_size, shuffle=False, num_workers=w,
                              drop_last=False)
        t0 = time.perf_counter()
        n = sum(int(batch["sample_valid"].sum()) for batch in loader)
        dt = time.perf_counter() - t0
        results[w] = n / dt
        print(f"[host-bench] workers={w}: {n / dt:.2f} samples/s ({dt / n * 1e3:.1f} "
              "ms/sample)", file=sys.stderr)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--points", type=int, default=40000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 1, 2, 4, 8])
    ap.add_argument("--collate-workers", type=int, nargs="+", default=[1, 2, 4],
                    help="thread-pool sizes of the parallel collate")
    args = ap.parse_args(argv)

    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_core_sample
    from instancerefer_tpu_torch.ops.voxelize import native_available

    spec = BatchSpec()
    rng = np.random.default_rng(0)
    print(f"[host-bench] native voxelizer: {native_available()}", file=sys.stderr)
    cores = [make_core_sample(rng, num_points=args.points, num_instances=12, num_candidates=4,
                              scan_idx=i, mean_size_arr=MEAN_SIZE)
             for i in range(args.samples)]
    phases = phase_split(cores[0], spec)
    for k, v in phases.items():
        print(f"[host-bench] {k}: {v:.2f}", file=sys.stderr)
    scaling = loader_scaling(cores, spec, args.batch_size, args.workers)
    coll = collate_scaling(cores, spec, args.batch_size, args.collate_workers)
    result = {
        "native_voxelizer": native_available(),
        "points_per_scene": args.points,
        "phase_ms": {k: round(v, 2) for k, v in phases.items()},
        "samples_per_sec_by_workers": {str(k): round(v, 2) for k, v in scaling.items()},
        "collate_ms": {k: round(v, 2) for k, v in coll.items()},
        "ncpu": os.cpu_count(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
