"""The benchmark of ``instancerefer_tpu_torch`` (the PyTorch and CUDA port
of InstanceRefer) on NVIDIA GPUs: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything the run does follows from data:
the cell's entry in ``BENCHMARK.json`` names its configuration (a file of
sizes under ``configs/``) and its traffic (``traffic/<name>.json``, which
names its driver, ``drivers/<name>.py``); each metric is a reader of its
own, ``metrics/<name>.py``; the limits of the check are in
``limits/<cell>.json``.  Adding a cell, a configuration or a metric adds
files and entries and edits none.

A run makes its inputs and weights from ``--seed``, sets up (the program's
kernels from its build directory in the checkout, the traffic's batches,
the weights, every step's warm-up and capture), measures for ``--seconds``,
and then holds what the timed path produced against the plain reference
(``reference/``, which imports nothing of the program): ``correct``.  The
last line of standard output is one JSON object; the numbers compared,
each with its limit, are the last lines of standard error and the
result's last key.  With ``--trace 1`` the metrics are the cell's
per-layer ones, read from a device trace taken after the window.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result.  ``--rehearse`` runs the same path on the
CPU at a tiny size in f32 (``REHEARSAL``) and prints its line with every
metric null: a test of the harness, not a measurement.  It exits with code 3, and prints no
result, if the process holds JAX or the JAX package once the window has
closed.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

from benchmark import check  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "instancerefer_tpu")
# the CPU rehearsal: scenes, capacities and a language grid a CPU steps
# through in seconds, the sparse convs in f32
REHEARSAL = {
    "config": {"scene_caps": [512, 256, 128, 64, 32], "inst_caps": [512, 256, 128, 64, 32],
               "max_instances": 16, "max_candidates": 4, "max_des_len": 24, "lang_bucket": 8,
               "compute_dtype": "float32"},
    "traffic": {"batch": 4, "lang_len": {"median": 6, "sigma": 0.5, "min": 3, "max": 24},
                "scene": {"num_points": 300, "num_instances": 5, "num_candidates": 3,
                          "points_per_instance": 8, "scene_extent": 1.5}},
}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's data, the run's arguments, the
    device, the process's start and the log."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    log: Callable[[str], None]


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_metric(name: str, root: str = ROOT):
    """The reader ``benchmark/metrics/<name>.py``: ``read(record) -> float | None``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", os.path.join(root, "benchmark", "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_data(root: str, name: str, rehearse: bool = False):
    """(the cell's entry, its configuration's values, its traffic, its
    end-to-end and per-layer metric entries, its limits) from the files."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    values = load_json(root, conf["file"])
    traffic = load_json(root, "benchmark", "traffic", f"{cell['traffic']}.json")
    if rehearse:
        values = {**values, **REHEARSAL["config"]}
        traffic = {**traffic, **REHEARSAL["traffic"]}

    def mine(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    limits_path = os.path.join(root, "benchmark", "limits", f"{name}.json")
    limits = load_json(limits_path)["limits"] if os.path.exists(limits_path) else {}
    return cell, values, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"]), limits


def smi(fields: str) -> Optional[str]:
    """``nvidia-smi``'s reading of ``fields`` for the first card."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


CARD_STATE = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU rehearsal at a tiny size: every metric null")
    args = ap.parse_args(argv)

    cell, values, traffic, e2e, per_layer, limits = cell_data(ROOT, args.workload, args.rehearse)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))
    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"needs {cell['chips']} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        log(f"card and power limit: {smi('name,power.limit')}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; SM and memory clocks, temperature, power, throttle "
            f"reasons: {smi(CARD_STATE)}")
    ctx = Context(cell, values, traffic, args.seed % 2**63, args.seconds,
                  bool(args.trace) and not args.rehearse, device, T0, log)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    record = driver.run(ctx)
    if not args.rehearse:
        log(f"after the run: SM and memory clocks, temperature, power, throttle reasons: "
            f"{smi(CARD_STATE)}")

    held = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if held:
        log(f"the process holds {held}: the benchmark runs without JAX and the JAX package")
        return 3

    numbers = record["numbers"]
    correct = bool(limits) and check.judge(numbers, limits)
    entries = per_layer if args.trace else e2e
    metrics = {}
    for m in entries:
        value = None if args.rehearse else load_metric(m["name"]).read(record)
        if value is None and not args.rehearse:
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "cpu" if args.rehearse else "gpu",
                   "kind": "cpu" if args.rehearse else torch.cuda.get_device_name(0),
                   "count": 0 if args.rehearse else int(cell["chips"]),
                   "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": record["steps"], "failed": record["failed"],
              "metrics": metrics, "device": device_info}
    prof = record.get("profile")
    if args.trace and prof is not None:
        device_info.update(busy_s=None if args.rehearse else prof["busy_s"],
                           window_s=None if args.rehearse else prof["window_s"])
        if not prof["agrees"]:
            log(f"kernel and device metrics left out: {prof['why']}")
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        if not args.rehearse:
            log(f"profiled window: {prof['steps']} steps, {prof['window_s']:.4f} s, device busy "
                f"{prof['busy_s']:.4f} s; launches seen {prof['seen']}, counted {prof['counted']}")
    log("readings beside the check: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items() if k not in limits))
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
