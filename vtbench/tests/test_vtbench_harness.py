"""The harness: its last line, discovery by name, the refusal without a
card, and the modules a run may not load. CPU only."""

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from vtbench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def _names(section, cell):
    return {m["name"] for m in BENCH[section]
            if "workloads" not in m or cell in m["workloads"]}


CELLS = [(w["name"], None) for w in BENCH["workloads"]] \
    + [("daycycle_8192", 4)]  # the day cycle sharded over four devices


@pytest.mark.parametrize("cell,devices", CELLS,
                         ids=[c + (f"-x{d}" if d else "") for c, d in CELLS])
def test_last_line_has_the_contract_keys_and_the_cell_metrics(cell, devices):
    rc, out = tiny.run(cell, devices=devices)
    assert rc == 0
    assert set(out) == KEYS
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["device"]["platform"] == "cpu"  # never named a device metric
    assert set(out["metrics"]) == _names("end_to_end", cell)
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "check"


def test_traced_run_reports_only_per_layer_metrics():
    rc, out = tiny.run("edit_8192", trace=1)
    assert rc == 0
    assert set(out) == KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # on the CPU no device metric has anything to read
    assert set(out["metrics"]) <= _names("per_layer", "edit_8192")
    assert not set(out["metrics"]) & _names("end_to_end", "edit_8192")


def test_every_named_file_is_found():
    from vtbench import bench, traffic

    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("vtbench/")
    for w in BENCH["workloads"]:
        assert traffic.load(w["traffic"])["limits"]
    for m in BENCH["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))


def test_a_new_cell_and_metric_need_new_files_only(tmp_path, monkeypatch):
    """A later PR adds a traffic mix, a cell and a per-layer metric as new
    files and entries: the harness finds them without an edit."""
    from vtbench import bench, traffic

    pkg = tmp_path / "vtbench"
    shutil.copytree(ROOT / "vtbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "workloads" / "fly_slow.json").write_text(
        (ROOT / "vtbench/workloads/fly.json").read_text())
    (pkg / "metrics" / "answer.fly_slow.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = json.loads(json.dumps(BENCH))
    b["workloads"].append(dict(b["workloads"][1], name="fly_slow_8192",
                               traffic="fly_slow"))
    b["per_layer"].append(dict(b["per_layer"][0], name="answer.fly_slow",
                               workloads=["fly_slow_8192"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(bench, "HERE", pkg)
    monkeypatch.setattr(bench, "ROOT", tmp_path)
    monkeypatch.setattr(traffic, "WORKLOADS", pkg / "workloads")
    cell, cfg, mix = bench.find_cell(bench.load_benchmark(tmp_path),
                                     "fly_slow_8192")
    assert mix["kind"] == "session" and cfg["name"] == "interactive_8192"
    assert bench.metric_reader("answer.fly_slow")(None) == 42.0
    assert "answer.fly_slow" in {m["name"] for m in bench.cell_metrics(
        b, "fly_slow_8192", "per_layer")}


def test_options_of_the_program_come_from_data(tmp_path, monkeypatch):
    """A configuration's ``renderer`` options reach the Renderer, and a
    traffic mix's ``headless`` options reach ``headless_run`` (a batch, a
    checkpoint every k samples), from new files and entries alone; the
    run with them is correct."""
    from vtbench import bench, traffic
    from voxtracer_torch.render import checkpoint, driver

    pkg = tmp_path / "vtbench"
    shutil.copytree(ROOT / "vtbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "vtbench/configs/headless_8192.json").read_text())
    cfg.update(name="headless_8192_svo", renderer={"use_hf": False})
    (pkg / "configs" / "headless_8192_svo.json").write_text(json.dumps(cfg))
    mix = traffic.load("daycycle")
    mix["headless"] = {"batch": 3, "checkpoint_every": 1}
    (pkg / "workloads" / "daycycle_b3.json").write_text(json.dumps(mix))
    b = json.loads(json.dumps(BENCH))
    b["configs"].append(dict(b["configs"][0], name="headless_8192_svo",
                             file="vtbench/configs/headless_8192_svo.json"))
    b["workloads"].append(dict(b["workloads"][0], name="daycycle_b3_svo",
                               config="headless_8192_svo",
                               traffic="daycycle_b3"))
    for m in b["end_to_end"]:
        if "daycycle_8192" in m.get("workloads", []):
            m["workloads"].append("daycycle_b3_svo")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(bench, "HERE", pkg)
    monkeypatch.setattr(bench, "ROOT", tmp_path)
    monkeypatch.setattr(traffic, "WORKLOADS", pkg / "workloads")
    seen = {"renderer": [], "headless": [], "saved": 0}
    init, run, save = (driver.Renderer.__init__, driver.headless_run,
                       checkpoint.save_render_state)

    def spy_init(self, *a, **k):
        seen["renderer"].append(k)
        init(self, *a, **k)

    def spy_run(*a, **k):
        seen["headless"].append(k)
        return run(*a, **k)

    def spy_save(*a, **k):
        seen["saved"] += 1
        return save(*a, **k)

    monkeypatch.setattr(driver.Renderer, "__init__", spy_init)
    monkeypatch.setattr(driver, "headless_run", spy_run)
    monkeypatch.setattr(checkpoint, "save_render_state", spy_save)
    rc, out = tiny.run("daycycle_b3_svo", seconds=1.0)
    assert rc == 0 and out["correct"] is True, out
    assert set(out["metrics"]) == {"paths_px_s", "setup_s"}
    assert seen["renderer"][0]["use_hf"] is False
    assert {(k["batch"], k["checkpoint_every"]) for k in seen["headless"]} \
        == {(3, 1)}
    assert seen["saved"] >= 2  # a frame of 4 samples: at 3 and at 4


def test_the_command_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "vtbench/run.py", "--workload", "daycycle_8192",
         "--seed", "5000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_a_forbidden_top_level_name_is_found_whole(monkeypatch):
    from vtbench import bench

    monkeypatch.setitem(sys.modules, "voxtracer_torch_lookalike",
                        types.ModuleType("voxtracer_torch_lookalike"))
    assert "voxtracer" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "voxtracer.core",
                        types.ModuleType("voxtracer.core"))
    assert "voxtracer" in bench.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh process (this one may hold what pytest loaded): a run
    through the test path, then the top-level names of sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from vtbench.tests import tiny\n"
        "rc, out = tiny.run('fly_8192')\n"
        "names = {m.split('.')[0] for m in sys.modules}\n"
        "print(rc, sorted(names & {'jax', 'jaxlib', 'flax', 'voxtracer'}))\n"
        % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.stdout.strip().splitlines()[-1] == "0 []", r.stderr[-2000:]


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "vtbench" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"voxtracer_torch", "voxtracer", "jax"}, path


def test_only_the_driver_imports_the_program():
    for path in (ROOT / "vtbench").rglob("*.py"):
        if "tests" in path.parts or path.name == "drive.py":
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "voxtracer_torch" not in tops, path
        assert not tops & {"voxtracer", "jax", "jaxlib", "flax"}, path
