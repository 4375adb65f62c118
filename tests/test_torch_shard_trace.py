"""The four-card day cycle's cell (``daycycle_8192_x4``) and the tracing of
what sample sharding adds (``dist/shard.py``), on the CPU.

The cell is found through ``BENCHMARK.json`` and runs on four CPU shards
through the benchmark's test path (``vtbench.bench.main(..., test=...)``),
each run in a fresh interpreter (a run refuses a process that loaded the
JAX package, as other test files of a worker do): correct, its metrics
reported, and not correct with one shard's radiance left out of the sum.
``run_shards`` runs every call in mesh order on the caller's thread,
over four distinct CPU devices (``torch.device("cpu", i)``, whose tensors
live on the CPU) as over one, and counts ``shard.calls.<k>``,
``shard.host_us.<k>`` and ``shard.graph_replays.<k>`` for each distinct
device only while the caller profiles. The spans
``vt:shards`` and ``vt:shard_sum`` sit under the span open around the
step. The readers of the cell's host metrics read hand-built traces and
registries, and give None where the program has none of it
(``shard_graph_share.x4``'s: tests/test_torch_shard_graph.py)."""

import json
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vtbench import bench, trace
from voxtracer_torch.core import camera as vcam
from voxtracer_torch.dist import mesh as vmesh
from voxtracer_torch.dist import shard
from voxtracer_torch.render.driver import Renderer
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import svo

ROOT = Path(__file__).resolve().parents[1]
CELL = "daycycle_8192_x4"
METRICS = ("shard_host_ms.x4", "step_host_ms.x4", "sum_ms.x4")
SHARE = "shard_graph_share.x4"  # replays over shard calls
CPU4 = [torch.device("cpu", i) for i in range(4)]  # four distinct devices
W, H = 32, 16
KW = dict(max_bounces=2, fog_steps=8)


def _world():
    """A 16^3 plane world (tests/test_torch_dist.py's ``plane``)."""
    n = 16
    solid = np.zeros((n, n, n), bool)
    solid[:, :2, :] = True
    rgb = np.zeros((n, n, n, 3), np.float32)
    rgb[solid] = 0.5
    return svo.from_dense(solid, rgb).serialize()


def _cam():
    return vcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)


SUN = np.array([0.3, 1.0, 0.2])


# -- the cell --

def test_the_x4_cell_is_found_through_the_benchmark():
    b = bench.load_benchmark()
    cell, cfg, mix = bench.find_cell(b, CELL)
    assert cell["chips"] == 4 and cell["config"] == "headless_8192_x4"
    assert cfg["devices"] == 4 and mix["kind"] == "headless"
    one = bench.find_cell(b, "daycycle_8192")[1]
    for key in ("world", "film", "pose", "sun", "day_step",
                "frame_samples", "precision"):
        assert cfg[key] == one[key], key
    assert mix == bench.find_cell(b, "daycycle_8192")[2]
    e2e = {m["name"] for m in bench.cell_metrics(b, CELL, "end_to_end")}
    assert e2e == {"paths_px_s", "setup_s"}
    layer = {m["name"]: m for m in bench.cell_metrics(b, CELL, "per_layer")}
    assert set(layer) == {*METRICS, SHARE}
    for m in layer.values():
        assert m["workloads"] == [CELL] and m["moves"] == "paths_px_s"
        assert bench.metric_reader(m["name"]) is not None


# the last shard's radiance left out of the sum
LAST_SHARD_OUT = """
import torch
from voxtracer_torch.dist import shard
orig = shard.run_shards
def run_shards(mesh, fn):
    out = orig(mesh, fn)
    return out[:-1] + [torch.zeros_like(out[-1])]
shard.run_shards = run_shards
"""


def _tiny(trace=0, fault="", seconds=2.0):
    """``vtbench.tests.tiny.run`` of the cell in a fresh interpreter, with
    ``fault`` run first: (exit code, the last line's object)."""
    code = (f"import json, sys\nsys.path.insert(0, {str(ROOT)!r})\n{fault}\n"
            "from vtbench.tests import tiny\n"
            f"print(json.dumps(tiny.run({CELL!r}, trace={trace}, "
            f"seconds={seconds})))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return tuple(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_tiny_x4_run_is_correct_and_reports_its_metrics():
    rc, out = _tiny()
    assert rc == 0
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"paths_px_s", "setup_s"}
    assert out["metrics"]["paths_px_s"]["value"] > 0
    assert out["device"]["count"] == 4


def test_a_traced_tiny_x4_run_reports_the_shard_metrics():
    # a frame is one step here, and the trace profiles from the window's
    # second: the window must outlast the first on a loaded host too (a
    # step took 1.3 s alone, 15-19 s beside the whole suite's six workers;
    # the profiler's stop, ~10 s, comes after the window either way)
    rc, out = _tiny(trace=1, seconds=30.0)
    assert rc == 0 and out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {*METRICS, SHARE}
    for name in METRICS:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    # CPU shards replay no CUDA graph
    assert out["metrics"][SHARE] == dict(value=0.0, unit="replays/call")


def test_a_tiny_x4_run_missing_one_shard_is_not_correct():
    rc, out = _tiny(fault=LAST_SHARD_OUT)
    assert rc == 0
    assert out["correct"] is False, out["check"]


# -- run_shards' loop and counters --

def _shard_counts():
    return {k: v for k, v in profiling.counts().items()
            if k.startswith("shard.")}


@pytest.mark.parametrize("devices", [CPU4, ["cpu"] * 3],
                         ids=["distinct-devices", "one-device"])
def test_run_shards_runs_in_turn_and_counts_only_while_profiling(devices):
    mesh = vmesh.make_mesh(devices=devices)
    cards = len(mesh.distinct)
    caller = threading.get_ident()
    ran = []

    def fn(i, dev):
        ran.append(i)
        time.sleep(0.002)
        return i, dev, threading.get_ident()

    profiling.reset()
    out = shard.run_shards(mesh, fn)
    assert [(i, d) for i, d, _ in out] == list(enumerate(mesh.devices))
    assert ran == list(range(mesh.size))  # in mesh order
    assert {t for _, _, t in out} == {caller}
    assert _shard_counts() == {}  # nothing counted, nothing profiled
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            shard.run_shards(mesh, fn)
    c = _shard_counts()
    calls = 2 * mesh.size // cards  # each distinct device's, two steps
    assert {c[f"shard.calls.{k}"] for k in range(cards)} == {calls}
    assert all(c[f"shard.host_us.{k}"] >= calls * 2000 for k in range(cards))
    assert {c[f"shard.graph_replays.{k}"] for k in range(cards)} == {0}
    assert len(c) == 3 * cards
    shard.run_shards(mesh, fn)
    assert _shard_counts() == c  # no profiler: no count
    profiling.reset()


def test_untraced_shards_take_no_lock_and_read_no_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("counted while nothing profiles")

    monkeypatch.setattr(profiling, "count", refuse)
    monkeypatch.setattr(shard.time, "perf_counter_ns", refuse)
    mesh = vmesh.make_mesh(devices=CPU4)
    assert shard.run_shards(mesh, lambda i, dev: i) == [0, 1, 2, 3]


def test_renderer_on_distinct_devices_equals_one_device_by_bits():
    """Four shards on four distinct devices give the same step, by bits,
    as the same four shards on one device."""
    dev = _world()
    r4 = Renderer(dev, W, H, seed=11, devices=CPU4, **KW)
    r1 = Renderer(dev, W, H, seed=11, devices=["cpu"] * 4, **KW)
    assert len(r4.mesh.distinct) == 4 and len(r1.mesh.distinct) == 1
    for _ in range(2):
        r4.sample(_cam(), SUN)
        r1.sample(_cam(), SUN)
    assert r4.acc.samples == r1.acc.samples == 8
    assert torch.equal(r4.acc.buffer, r1.acc.buffer)


# -- the spans --

def _parents(prof, names):
    return sorted((e.name, e.cpu_parent.name if e.cpu_parent else None)
                  for e in prof.events() if e.name in names)


@pytest.mark.parametrize("devices", [CPU4, ["cpu"] * 4],
                         ids=["distinct-devices", "one-device"])
def test_sample_step_spans_sit_under_the_renderers_sample(devices):
    r = Renderer(_world(), W, H, seed=5, devices=devices, **KW)
    r.sample(_cam(), SUN)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.sample(_cam(), SUN)
    assert _parents(prof, ("vt:shards", "vt:shard_sum")) == [
        ("vt:shard_sum", "vt:sample"), ("vt:shards", "vt:sample")]


def test_tile_step_span_sits_under_the_callers_span():
    r = Renderer(_world(), W, H, seed=5, device="cpu", **KW)
    mesh = vmesh.make_mesh(devices=CPU4)
    w = r.world
    step = shard.tile_sharded_step(mesh, w.table, w.root, w.height, r.lut,
                                   W, H, **KW)
    cam = _cam()
    sun = torch.from_numpy((SUN / np.linalg.norm(SUN)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("outer"):
            frame = step(np.array([1, 2, 3], np.uint32),
                         np.asarray(cam.pos, np.float32), cam.basis(), sun)
    assert frame.shape == (step.out_rows, W, 3)
    assert _parents(prof, ("vt:shards", "vt:shard_sum")) == [
        ("vt:shards", "outer")]


# -- the readers --

def _x(name, ts, dur, cat="user_annotation", **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, args=args)


# two profiled steps: the shards 30 and 34 ms of host, the sums 0.2 and
# 0.4 ms; three peer copies of 20 us onto card 0 a step, on cards 1-3
STEPS = [
    _x("vtb:sample", 0, 36000), _x("vt:sample", 10, 35900),
    _x("vt:shards", 100, 30000), _x("vt:shard_sum", 30200, 200),
    _x("vtb:sample", 40000, 40000), _x("vt:sample", 40010, 39900),
    _x("vt:shards", 40100, 34000), _x("vt:shard_sum", 74200, 400),
    _x("path_cast_kernel", 500, 5000, "kernel", device=0),
] + [_x("Memcpy PtoP (Device -> Device)", t + 30210 + 40 * c, 20,
        "gpu_memcpy", device=c) for t in (0, 44000) for c in (1, 2, 3)] \
    + [_x("Memcpy HtoD (Pageable -> Device)", 50, 10, "gpu_memcpy",
          device=0)]


def _run(events, requests=8):
    ev = trace.Events([_x(trace.WINDOW, 0, 100000)] + events, requests)
    return bench.Run(events=ev)


def _read(metric, run):
    return bench.metric_reader(metric)(run)


def test_span_readers_read_the_steps(capsys):
    run = _run(STEPS)
    assert _read("step_host_ms.x4", run) == pytest.approx(32.0)
    assert _read("sum_ms.x4", run) == pytest.approx(0.3)
    err = capsys.readouterr().err
    assert "2 vt:shards spans, 2 vt:sample spans" in err
    assert "card 0: 0 peer copies, 0.0000 ms" in err
    for c in (1, 2, 3):
        assert f"card {c}: 2 peer copies, 0.0200 ms" in err


def _profiled(calls):
    """The registry as traced steps leave it: ``calls`` is
    ``{card: [host us of each call]}``."""
    profiling.reset()
    for k, us in calls.items():
        for u in us:
            profiling.count(f"shard.host_us.{k}", u)
            profiling.count(f"shard.calls.{k}")


def test_shard_host_reader_reads_the_registry(capsys):
    _profiled({0: [9000, 11000], 1: [10000, 10000], 2: [30000, 10000],
               3: [12000, 8000]})
    assert _read("shard_host_ms.x4", _run(STEPS)) == pytest.approx(12.5)
    err = capsys.readouterr().err
    assert "card 0: 2 calls, 10.0000 ms a call" in err
    assert "card 2: 2 calls, 20.0000 ms a call" in err
    profiling.reset()


@pytest.mark.parametrize("metric", ["step_host_ms.x4", "sum_ms.x4"])
def test_span_readers_give_none_without_the_ports_spans(metric):
    """The trace of a program without the shard spans, and an untraced
    run."""
    theirs = [e for e in STEPS if not e["name"].startswith("vt:shard")]
    assert _read(metric, _run(theirs)) is None
    assert _read(metric, bench.Run(events=None)) is None


def test_shard_host_reader_gives_none_without_the_counts(monkeypatch):
    """No shard counted, an untraced run, and a program whose profiling
    module has no registry."""
    profiling.reset()
    profiling.count("launches.path_trace", 3)
    assert _read("shard_host_ms.x4", _run(STEPS)) is None
    _profiled({0: [1000]})
    assert _read("shard_host_ms.x4", bench.Run(events=None)) is None
    monkeypatch.setitem(sys.modules, "voxtracer_torch.utils.profiling",
                        types.ModuleType("voxtracer_torch.utils.profiling"))
    assert _read("shard_host_ms.x4", _run(STEPS)) is None
    profiling.reset()
