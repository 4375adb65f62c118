"""The port's tracer (``voxtracer_torch/utils/profiling.py``): the ``vt:``
spans the Renderer, its preview, its edits and the pick name inside a
profiled run, each inside its parent; the shared null span with no
profiler; the counter registry under threads; K9's queue tensors kept
only while the profiler records. CPU only."""

import contextlib
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxtracer_torch.app import interactive
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import build, integrator
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import worldgen as tgen

SUN = np.asarray([0.8, 10.2743, 3.7])

# each span and the span it opens inside (None: at the top)
PARENT = {
    "vt:sample": None, "vt:begin": "vt:sample", "vt:engine_kw": "vt:sample",
    "vt:soup": "vt:engine_kw", "vt:bins": "vt:engine_kw",
    "vt:sun_maps": "vt:engine_kw", "vt:primary": "vt:sample",
    "vt:first_hits": "vt:sample", "vt:k9": "vt:sample",
    "vt:acc_add": "vt:sample",
    "vt:sky_env.build.t0": "vt:sky_env", "vt:sky_env.build.t1": "vt:sky_env",
    "vt:preview": None, "vt:frame_cast": "vt:preview",
    "vt:apply_edits": None, "vt:edits.delta": "vt:apply_edits",
    "vt:edits.table": "vt:apply_edits", "vt:edits.soup": "vt:apply_edits",
    "vt:edits.hf": "vt:apply_edits", "vt:edits.bounds": "vt:apply_edits",
    "vt:pick": None,
}
SKY_ENV_PARENTS = {"vt:engine_kw", "vt:preview"}


def _spans(prof, tmp_path):
    """(name, the name of the innermost vt: span around it) of every vt:
    span in the profiler's trace, by the intervals on each thread."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    evs = sorted((float(e["ts"]), -float(e["dur"]), e["tid"], e["name"])
                 for e in raw.get("traceEvents", raw)
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith("vt:"))
    out, open_ = [], {}
    for ts, neg, tid, name in evs:
        stack = open_.setdefault(tid, [])
        while stack and stack[-1][0] <= ts:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((ts - neg, name))
    return out


def _world():
    space = tgen.generate(log2_size=6, verbose=False, device="cpu")
    cam = tcam.Camera(pos=(0.62 * 64, float(space.heights.max()) + 5.0,
                           0.35 * 64), yaw=2.2, pitch=1.2)
    return space, cam


def _session(r, space, cam):
    """A preview, two samples and a pick with a placed block, as the app
    makes them."""
    r.preview_frame(cam, SUN)
    r.sample(cam, SUN)
    r.sample_batch(cam, SUN, 2)
    voxel, normal = interactive.center_pick(r.world, cam.pos, cam.yaw,
                                            cam.pitch)
    e = tuple(int(c) for c in voxel + normal)
    space.set(e, (1.0, 1.0, 1.0))
    r.apply_edits(space, edits=[e])
    r.sample(cam, SUN)


@pytest.mark.parametrize("hf_only", [True, False],
                         ids=["hf-only", "soup"])
def test_layers_give_their_spans_each_inside_its_parent(monkeypatch,
                                                        tmp_path, hf_only):
    """Profiled, the session's calls give every named vt: span of their
    engine (hf-only: the envelope's two tier builds and no soup; the
    soup: the soup's patch and no envelope), each inside its parent."""
    if hf_only:
        monkeypatch.setattr(tdrv.Renderer, "HF_FRAME_SIZE", 32)
    space, cam = _world()
    r = tdrv.Renderer(space.serialize(), 32, 24, max_bounces=2,
                      fog_steps=4, seed=3, device="cpu")
    assert r._hf_only() is hf_only
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _session(r, space, cam)
    spans = _spans(prof, tmp_path)
    names = {n for n, _ in spans}
    for name, parent in spans:
        if name == "vt:sky_env":
            assert parent in SKY_ENV_PARENTS
        else:
            assert PARENT[name] == parent, name
    want = set(PARENT) | {"vt:sky_env"}
    if hf_only:
        want -= {"vt:edits.soup"}
    else:  # no envelope: its lookup finds no hf-only world
        want -= {"vt:sky_env.build.t0", "vt:sky_env.build.t1"}
    assert names == want
    count = {n: sum(1 for m, _ in spans if m == n) for n in names}
    for name in ("vt:sample", "vt:begin", "vt:engine_kw", "vt:primary",
                 "vt:first_hits", "vt:k9", "vt:acc_add"):
        assert count[name] == 3, name  # once a sample call
    if hf_only:  # tier 0 at the preview, tier 1 at the first sample
        assert count["vt:sky_env.build.t0"] == 1
        assert count["vt:sky_env.build.t1"] == 1


def test_no_profiler_no_span(monkeypatch):
    """With no profiler recording, span() is one shared null context and
    no record_function is made."""
    assert profiling.span("vt:a") is profiling.span("vt:b")
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: made.append(name))
    space, cam = _world()
    r = tdrv.Renderer(space.serialize(), 32, 24, max_bounces=2,
                      fog_steps=4, seed=3, device="cpu")
    r.preview_frame(cam, SUN)
    r.sample(cam, SUN)
    assert made == []
    assert profiling.span("vt:a") is profiling.span("vt:b")


def test_registry_counts_exactly_under_threads():
    """Eight threads counting at once lose no increment."""
    reg = profiling.Counters()
    n, threads = 20000, 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [reg.count("c") for _ in range(n)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    reg.count("d", 5)
    assert reg.counts() == {"c": n * threads, "d": 5}
    reg.reset()
    assert reg.counts() == {}


def _fake_k9(monkeypatch, rows):
    """``_trace_paths_k9`` on the CPU: the C call and its stream faked,
    the call's counters tensor ``rows`` (bounces, K9_COUNTERS)."""
    lib = types.SimpleNamespace(voxt_path_trace=lambda *a: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def args(*a, **k):
        keep = dict(work=torch.zeros(len(integrator.K9_WORK),
                                     dtype=torch.int64),
                    counters=rows.clone())
        return (), (torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.int32),
                    (4,), keep)

    monkeypatch.setattr(integrator, "k9_args", args)

    def call():
        return integrator._trace_paths_k9(*([None] * 5), torch.zeros(4, 3),
                                          *([None] * 3), 2, 4,
                                          *([None] * 7), 0, 0)
    return call


def test_k9_keeps_its_queues_only_while_the_profiler_records(monkeypatch):
    """Each K9 call counts a launch; its queue lengths are kept while
    the profiler records and summed over bounces when the registry is
    read, as k9.queued.<queue>."""
    rows = torch.arange(2 * integrator.K9_COUNTERS,
                        dtype=torch.int32).reshape(2, -1)
    call = _fake_k9(monkeypatch, rows)
    profiling.reset()
    call()
    assert profiling.COUNTERS._held == []
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    assert len(profiling.COUNTERS._held) == 2
    call()
    c = profiling.counts()
    assert c["launches.path_trace"] == 4 and c["k9.queued.calls"] == 2
    for i, q in enumerate(integrator.K9_QUEUES):
        assert c[f"k9.queued.{q}"] == 2 * int(rows[:, i].sum()), q
    assert profiling.COUNTERS._held == []
    assert profiling.counts()["k9.queued.calls"] == 2  # read once
    profiling.reset()
