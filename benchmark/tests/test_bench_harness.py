"""The harness on the CPU: cells, configurations and metrics found from
files alone; no JAX; each cell's rehearsal to a last line with every
time-derived value null; the exits without a card and with JAX held; the
trace's busy and idle arithmetic.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run, trace

ROOT = run.ROOT
BANNED = {"jax", "jaxlib", "flax", "instancerefer_tpu"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(run.HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_jax_and_a_reference_apart_from_the_program():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)
        if os.sep + "reference" + os.sep in path:
            assert "instancerefer_tpu_torch" not in tops, path
            assert not any(m.startswith("benchmark.") and not m.startswith("benchmark.reference")
                           for m in _imports(path)), path


def test_new_cell_config_and_metric_from_new_files_only(tmp_path):
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(run.HERE, sub), tmp_path / "benchmark" / sub)
    bench = _bench()
    conf = dict(bench["configs"][0], name="instancerefer-scanrefer-normal",
                file="benchmark/configs/instancerefer-scanrefer-normal.json")
    with open(os.path.join(ROOT, bench["configs"][0]["file"])) as f:
        values = dict(json.load(f), use_normal=True)
    (tmp_path / conf["file"]).write_text(json.dumps(values))
    traffic = json.loads((tmp_path / "benchmark/traffic/resident-eval-b64.json").read_text())
    (tmp_path / "benchmark/traffic/resident-eval-b32.json").write_text(
        json.dumps(dict(traffic, batch=32)))
    (tmp_path / "benchmark/metrics/steps_s.py").write_text(
        "def read(record):\n    return record['steps'] / record['window_s']\n")
    cell = {"name": "normal-eval-b32", "config": conf["name"], "traffic": "resident-eval-b32",
            "chips": 1, "why": "a cell added as data"}
    bench["configs"].append(conf)
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_s", "unit": "steps/s", "better": "higher",
                               "source": "host_clock", "layer": "step graphs",
                               "moves": "eval_scenes_s", "workloads": [cell["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got, values_got, traffic_got, e2e, per_layer, _ = run.cell_data(str(tmp_path), cell["name"])
    assert got == cell and values_got["use_normal"] and traffic_got["batch"] == 32
    assert [m["name"] for m in per_layer] == ["steps_s"]
    assert [m["name"] for m in e2e] == ["setup_s"]
    assert run.load_metric("steps_s", str(tmp_path)).read({"steps": 10, "window_s": 4.0}) == 2.5


def _rehearse(cell, *extra):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
                           "2147483903", "--seconds", "1", "--rehearse", *extra],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_rehearsal_last_line(cell):
    proc = _rehearse(cell, "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"] and all(m["value"] is None for m in result["metrics"].values())
    assert result["device"]["memory_peak_bytes"] is None
    assert "check caps_exceeded" in proc.stderr.strip().splitlines()[-1]


def test_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           _bench()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a card is present")
    assert proc.returncode == 2 and proc.stdout == ""


def test_no_result_with_jax_held(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc = run.main(["--workload", "xyzrgbh-eval-resident", "--seed", "3", "--seconds", "0.2",
                   "--rehearse"])
    assert rc == 3 and capsys.readouterr().out == ""


def test_trace_busy_idle_and_gaps():
    w = {"wall_s": 1.0, "agrees": True, "why": None, "seen": {}, "counted": {},
         "device": [("a", 0, 100_000), ("b", 50_000, 200_000), ("c", 400_000, 500_000)],
         "host": [("step", 0, 300_000), ("metrics_to_host", 250_000, 450_000)]}
    s = trace.summarize(w)
    assert s["busy_s"] == pytest.approx(0.3)
    assert s["idle_gaps"][0][1] == pytest.approx(0.2)
    assert s["idle_gaps"][0][0].startswith("metrics_to_host")
    assert s["device_ops"][0] == ["b", pytest.approx(0.15)]
