"""Fit the padded capacities to a dataset, the port's counterpart of the
JAX package's ``scripts/calibrate_bands.py --fit-caps``:

    python -m instancerefer_tpu_torch.scripts.fit_caps --config config/InstanceRefer.yaml \\
        --data_root data --fit-caps --emit-yaml profile.yaml [--cap-margin 0.1]
    python -m instancerefer_tpu_torch.scripts.fit_caps --synthetic --points 10000 40000 80000 \\
        --fit-caps --emit-yaml profile.yaml

It measures ``--batches x --batch_size`` samples: the uncapped row count of
every pyramid stage (the port's ``ops/voxelize.build_pyramid_padded``
reports the merged counts before truncation, whatever the caps), the
candidates under the GT-class filter (the default ``use_gt_lang: True``),
and the instances.  Each cap is ``ceil(max * (1 + cap_margin))`` rounded up
to a multiple of 64 rows, the row tile of the sparse-conv kernels
(``BM``, ``csrc/sparse_conv_tc.cuh``); ``max_candidates`` rounds to 4,
``max_instances`` to 8.  ``--emit-yaml`` writes a profile whose ``TPU:``
section a config loads through its ``band_profile`` key
(``config.band_profile_kwargs``).  The JAX tool also calibrates its band
geometry, which the port does not have: fitting the capacities is all this
tool does, and ``--fit-caps`` is accepted for the same command line.  It
only counts, on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Iterable, List, Optional

import numpy as np

from instancerefer_tpu_torch.data.pipeline import BatchSpec, CoreSample

ROW_TILE = 64  # BM of csrc/sparse_conv_tc.cuh: a cap's multiple


def fit_caps(cores: Iterable[CoreSample], spec: BatchSpec, cap_margin: float):
    """(recommended capacities, distribution stats) of ``cores``; the
    stats have the keys and values of the JAX package's ``fit_caps``."""
    from instancerefer_tpu_torch.ops import voxelize as V

    ns = len(spec.scene_caps)
    scene_counts, inst_counts, n_cand, n_inst = [], [], [], []
    for core in cores:
        pc = core.point_cloud
        coords, _ = V.quantize(pc[:, :3], pc[:, :1], 0.05)
        scene_counts.append(V.build_pyramid_padded([coords], [0], spec.scene_caps)[1])
        fclass = core.object_cat if core.filter_class is None else core.filter_class
        cand = [i for i, c in enumerate(core.instance_class) if int(c) == fclass]
        n_cand.append(len(cand))
        n_inst.append(len(core.instance_points))
        if len(cand) >= 2:
            groups = [V.quantize(core.instance_points[i][:, :3], core.instance_points[i][:, :1],
                                 0.02)[0] for i in cand[:spec.max_candidates]]
            inst_counts.append(V.build_pyramid_padded(groups, range(len(groups)),
                                                      spec.inst_caps)[1])
    scene_counts = np.asarray(scene_counts)
    inst_counts = np.asarray(inst_counts) if inst_counts else np.zeros((1, ns), np.int64)

    def caps(counts):
        need = np.ceil(counts.max(0) * (1.0 + cap_margin)).astype(int)
        return [max(-(-int(n) // ROW_TILE) * ROW_TILE, ROW_TILE) for n in need]

    def roundup(n, m):
        return max(-(-int(np.ceil(n * (1.0 + cap_margin))) // m) * m, m)

    rec = {
        "scene_caps": caps(scene_counts),
        "inst_caps": caps(inst_counts),
        "max_candidates": roundup(max(n_cand), 4),
        "max_instances": roundup(max(n_inst), 8),
    }
    stats = {"samples": len(scene_counts)}
    for key, counts in (("scene", scene_counts), ("inst", inst_counts)):
        stats[f"{key}_p50"] = np.percentile(counts, 50, axis=0).astype(int).tolist()
        stats[f"{key}_p95"] = np.percentile(counts, 95, axis=0).astype(int).tolist()
        stats[f"{key}_max"] = counts.max(axis=0).astype(int).tolist()
    stats["cand_max"] = int(max(n_cand))
    stats["inst_count_max"] = int(max(n_inst))
    return rec, stats


def profile_text(fitted: dict, source: str, cap_margin: float) -> str:
    """The profile a config's ``band_profile`` key loads: a ``TPU:``
    section of the four capacity keys."""
    return "\n".join([
        "# Capacity profile written by instancerefer_tpu_torch/scripts/fit_caps.py;",
        "# re-run the tool after changing the data.",
        f"# source: {source}, margin {cap_margin:.0%} over the measured max, caps in "
        f"multiples of {ROW_TILE} rows, written {time.strftime('%Y-%m-%d')}",
        "TPU:",
        *(f"  {k}: {v}" for k, v in fitted.items()),
        "",
    ])


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config/InstanceRefer.yaml")
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--split", default="train")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--synthetic", action="store_true",
                    help="fit on synthetic ScanRefer-scale scenes (no dataset needed)")
    ap.add_argument("--points", type=int, nargs="+", default=None,
                    help="with --synthetic: these scene sizes (points per scene); default "
                         "the config's num_points")
    ap.add_argument("--emit-yaml", default=None, metavar="PATH",
                    help="write the fitted capacities as a profile for the band_profile key")
    ap.add_argument("--fit-caps", action="store_true",
                    help="fit the capacities (all this tool does)")
    ap.add_argument("--cap-margin", type=float, default=0.10,
                    help="fractional headroom above the measured maximum")
    args = ap.parse_args(argv)
    if args.points and not args.synthetic:
        ap.error("--points only applies with --synthetic")

    from instancerefer_tpu_torch.config import load_config

    cfg = load_config(["--config", args.config, "--data_root", args.data_root])
    spec = cfg.batch_spec()
    n = args.batches * args.batch_size

    def cores():
        if args.synthetic:
            from instancerefer_tpu_torch.data.synthetic import make_core_sample

            mean_size = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
            for pts in args.points or [cfg.num_points]:
                ninst = max(6, min(16, pts // 5000))
                rng = np.random.default_rng(0)
                for i in range(n):
                    yield make_core_sample(rng, num_points=pts, num_instances=ninst,
                                           num_candidates=4, scan_idx=i, mean_size_arr=mean_size)
        else:
            from instancerefer_tpu_torch.data.dataset import (
                ScannetReferenceDataset,
                get_scanrefer,
            )

            ds = ScannetReferenceDataset(
                get_scanrefer(args.data_root, args.split), args.split,
                data_root=args.data_root, num_points=cfg.num_points, use_augment=False,
                use_color=cfg.use_color, use_normal=cfg.use_normal,
                use_multiview=cfg.use_multiview, use_height=cfg.use_height)
            for i in np.random.default_rng(0).permutation(len(ds))[:n]:
                yield ds.get_core(int(i))

    fitted, stats = fit_caps(cores(), spec, args.cap_margin)
    print(f"# capacity fit over {stats['samples']} samples (margin {args.cap_margin:.0%}):")
    for k in ("scene", "inst"):
        print(f"#   {k}_rows p50={stats[f'{k}_p50']} p95={stats[f'{k}_p95']} "
              f"max={stats[f'{k}_max']}")
    print(f"#   candidates max={stats['cand_max']}, instances max={stats['inst_count_max']}")
    print("# fitted capacities (overflow-free on this data by construction):")
    for k, v in fitted.items():
        print(f"  {k}: {v}")
    if args.emit_yaml:
        source = (f"synthetic points={args.points or [cfg.num_points]}" if args.synthetic
                  else f"dataset={args.data_root} split={args.split}")
        with open(args.emit_yaml, "w") as f:
            f.write(profile_text(fitted, f"{source}, {stats['samples']} samples",
                                 args.cap_margin))
        print(f"# wrote the capacity profile: {args.emit_yaml}")
    return fitted


if __name__ == "__main__":
    main()
