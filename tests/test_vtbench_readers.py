"""The benchmark's readers of the port's spans and counters
(``vtbench/metrics/``: ``sample_host_ms.daycycle``,
``sample_sync_ms.daycycle``, ``envelope_host_ms.fly``,
``recast_lanes.edit``) on small hand-built traces, and on traces of a
program without the spans or counters (None). CPU only."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vtbench import bench, trace
from voxtracer_torch.kernels import integrator
from voxtracer_torch.utils import profiling


def _x(name, ts, dur, cat="user_annotation", **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, args=args)


def _run(events, requests, **kw):
    ev = trace.Events([_x(trace.WINDOW, 0, 100000)] + events, requests)
    return bench.Run(events=ev, **kw)


def _read(metric, run):
    return bench.metric_reader(metric)(run)


# two profiled samples inside the benchmark's spans: 1000 us with a 100
# us stream sync in vt:acc_add, 2000 us with a 300 us device sync in
# vt:k9 and a 100 us synchronous copy; the async copy and a sync outside
# every sample are not counted
DAY = [
    _x("vtb:sample", 90, 1020), _x("vt:sample", 100, 1000),
    _x("vt:acc_add", 850, 200),
    _x("cudaMemcpyAsync", 800, 50, "cuda_runtime"),
    _x("cudaStreamSynchronize", 900, 100, "cuda_runtime"),
    _x("vtb:sample", 1990, 2020), _x("vt:sample", 2000, 2000),
    _x("vt:k9", 2100, 900),
    _x("cudaDeviceSynchronize", 2500, 300, "cuda_runtime"),
    _x("cudaMemcpy", 3500, 100, "cuda_runtime"),
    _x("cudaStreamSynchronize", 5000, 1000, "cuda_runtime"),
    _x("path_cast_kernel", 950, 40, "kernel", device=0),
]


def test_sample_readers_split_the_sample_into_host_and_sync(capsys):
    run = _run(DAY, 2)
    host = _read("sample_host_ms.daycycle", run)
    sync = _read("sample_sync_ms.daycycle", run)
    assert host == pytest.approx((0.9 + 1.6) / 2)
    assert sync == pytest.approx((0.1 + 0.4) / 2)
    assert host + sync == pytest.approx(1.5)  # the vt:sample spans' mean
    err = capsys.readouterr().err
    assert "2 vt:sample spans, 2 profiled samples" in err
    assert "cudaStreamSynchronize under vt:acc_add: 1 calls, 0.0500" in err
    assert "cudaDeviceSynchronize under vt:k9: 1 calls, 0.1500" in err
    assert "cudaMemcpy under vt:sample: 1 calls, 0.0500" in err


# two profiled moves: each a tier-0 build at the preview and a tier-1
# build at the sample; the device work starting in them is 500 and 250 us
# the first move, 300 (two overlapping kernels) and 0 the second
FLY = [
    _x("vtb:preview", 0, 4000), _x("vt:preview", 10, 3900),
    _x("vt:sky_env", 20, 3100), _x("vt:sky_env.build.t0", 30, 3000),
    _x("roll_cuda_kernel", 100, 500, "kernel", device=0),
    _x("vt:sky_env.build.t1", 5000, 1000),
    _x("maximum_kernel", 5100, 250, "kernel", device=0),
    _x("vt:sky_env.build.t0", 10000, 2000),
    _x("roll_cuda_kernel", 10100, 200, "kernel", device=0),
    _x("roll_cuda_kernel", 10200, 200, "kernel", device=0),
    _x("vt:sky_env.build.t1", 15000, 1000),
]


def test_envelope_reader_sums_the_builds_a_move(capsys):
    assert _read("envelope_host_ms.fly", _run(FLY, 2)) \
        == pytest.approx((3.0 + 1.0 + 2.0 + 1.0) / 2)
    err = capsys.readouterr().err
    assert ("vt:sky_env.build.t0: 1.000 builds a move, host 2.5000 ms, "
            "device union 0.4000 ms a move") in err
    assert ("vt:sky_env.build.t1: 1.000 builds a move, host 1.0000 ms, "
            "device union 0.1250 ms a move") in err


@pytest.mark.parametrize("metric,events", [
    ("sample_host_ms.daycycle", DAY), ("sample_sync_ms.daycycle", DAY),
    ("envelope_host_ms.fly", FLY)])
def test_span_readers_give_none_without_the_ports_spans(metric, events):
    """The trace of a program without the vt: spans (the benchmark's own
    vtb: spans and the device events only), and an untraced run."""
    theirs = [e for e in events if not e["name"].startswith("vt:")]
    assert _read(metric, _run(theirs, 2)) is None
    assert _read(metric, bench.Run(events=None)) is None


def _held(rows):
    """The registry holding K9's queue tensors ``rows`` while a profiler
    records, as ``_trace_paths_k9`` holds them."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for r in rows:
            profiling.hold("k9.queued", integrator.K9_QUEUES,
                           r[:, :len(integrator.K9_QUEUES)])


def test_recast_reader_reads_the_registry_a_sample(capsys):
    q = integrator.K9_QUEUES
    a = torch.zeros((3, integrator.K9_COUNTERS), dtype=torch.int32)
    a[:, q.index("recast")] = torch.tensor([40, 10, 0], dtype=torch.int32)
    a[:, q.index("shadow_recast")] = 5
    a[:, q.index("live")] = 1000
    b = a.clone()
    b[0, q.index("recast")] = 100
    _held([a, b])
    run = _run(DAY, 2)
    assert _read("recast_lanes.edit", run) \
        == pytest.approx((50 + 15 + 110 + 15) / 2)
    err = capsys.readouterr().err
    assert "2 K9 calls kept, 2 vt:sample spans" in err
    assert "live 3000.0" in err and "recast 80.0" in err
    profiling.reset()


def test_recast_reader_gives_none_without_the_registry(monkeypatch):
    """No K9 call kept, an untraced run, and a program whose profiling
    module has no registry."""
    profiling.reset()
    assert _read("recast_lanes.edit", _run(DAY, 2)) is None
    _held([torch.ones((2, integrator.K9_COUNTERS), dtype=torch.int32)])
    assert _read("recast_lanes.edit", bench.Run(events=None)) is None
    monkeypatch.setitem(sys.modules, "voxtracer_torch.utils.profiling",
                        types.ModuleType("voxtracer_torch.utils.profiling"))
    assert _read("recast_lanes.edit", _run(DAY, 2)) is None
    profiling.reset()
