"""The sample-sharded step's CUDA graphs (``dist/shard.py``).

On the CPU: the policy. A mesh that is not all cards, or a step with a
soup, never captures and runs eagerly; the capture key changes with the
pose and the envelope, and a new step object starts with no graphs; the
first call with a key runs eagerly, the second captures, a new key drops
the graphs. The step's wiring runs with a stand-in for the graphs
(``_FakeGraphs``: ``_CardGraphs.replay`` over graphs that run each
entry's ``render_sample`` from its int64 seed buffer), against the same
Renderer run eagerly, by bits; a traced replayed step counts its calls
and replays through ``run_shards``, an eager one its calls only. The
registry's ``recording`` diverts a thread's counts; the metric
``shard_graph_share.x4`` and ``shard_host_ms.x4`` read the registry as a
graphed step leaves it, and give None without their counts.

On a card (every test below ``cuda`` skips without one): a graphed step
equals the serial mesh-order sum of the same eager ``render_sample``
calls by bits, on one card repeated four times and on four cards, over
steps with new seeds, a sun changed between two replays and a new pose
(a new capture); a Renderer's graphed steps run with no host sync
between them under ``set_sync_debug_mode("error")``, a sun change among
them, and still equal that sum; the step after ``Renderer.apply_edits``
is a new object and captures again; a soup step stays eager; the counters read what ran.
Run there from the repository root:
    python -m pytest tests/test_torch_shard_graph.py -q --noconftest
"""

import functools
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vtbench import bench, trace
from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core import rng as vrng
from voxtracer_torch.dist import mesh as vmesh
from voxtracer_torch.dist import shard
from voxtracer_torch.kernels import integrator
from voxtracer_torch.render.driver import Renderer
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import worldgen

torch.set_num_threads(2)
W, H = 32, 16
KW = dict(max_bounces=2, fog_steps=8)
SUN = np.array([0.8, 10.2743, 3.7])
CAM_A = vcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
CAM_B = vcam.Camera(pos=(13.0, 14.0, 6.0), yaw=0.5, pitch=0.4)
CUDA4 = (torch.device("cuda", 0),) * 4


def _space():
    return worldgen.generate(log2_size=5, verbose=False, device="cpu")


def _renderer(devices, use_soup=False, hf_only=False, space=None):
    """A 32^3 terrain Renderer sharding over ``devices``; ``hf_only``
    lowers ``HF_FRAME_SIZE`` so that the envelope serves the primaries."""
    r = Renderer((space or _space()).serialize(), W, H, seed=3,
                 device="cpu", devices=devices, use_soup=use_soup, **KW)
    if hf_only:
        r.HF_FRAME_SIZE = 32
        assert r._hf_only()
    return r


def _shard_counts():
    return {k: v for k, v in profiling.counts().items()
            if k.startswith("shard.")}


# -- the policy, on the CPU --

def _world(soup=None):
    return types.SimpleNamespace(soup=soup)


@pytest.mark.parametrize("devices,soup,dynamic,bins,want", [
    (CUDA4, None, False, None, True),
    ((torch.device("cuda", 0), torch.device("cuda", 1)), None, False, None,
     True),
    (("cpu",) * 4, None, False, None, False),
    ((torch.device("cuda", 0), torch.device("cpu")), None, False, None,
     False),
    (CUDA4, "soup", False, None, False),
    (CUDA4, None, True, None, False),
    (CUDA4, None, False, "bins", False),
], ids=["one-card", "two-cards", "cpu", "mixed", "soup", "dynamic-soup",
        "bins"])
def test_only_an_all_card_mesh_without_a_soup_is_graphable(devices, soup,
                                                          dynamic, bins,
                                                          want):
    mesh = vmesh.Mesh(devices=tuple(torch.device(d) for d in devices))
    assert shard._graphable(mesh, _world(soup), dynamic, bins) is want


def test_the_key_changes_with_the_pose_and_the_envelope():
    mesh = vmesh.make_mesh(devices=["cpu"] * 2)
    E = shard.replicate(mesh, torch.zeros(4, 2))
    env = (E, 2.0, 1.5, 256)
    pos = np.asarray(CAM_A.pos, np.float32)
    key = shard._pose_key(pos, CAM_A.basis(), env)
    # the same pose from new objects, the same envelope objects
    assert shard._same_key(key, shard._pose_key(
        np.asarray(CAM_A.pos, np.float32), CAM_A.basis(), tuple(env)))
    moved = pos.copy()
    moved[0] = np.nextafter(moved[0], np.float32(1e9))
    assert not shard._same_key(key, shard._pose_key(moved, CAM_A.basis(),
                                                    env))
    assert not shard._same_key(key, shard._pose_key(pos, CAM_B.basis(), env))
    # an envelope with the same values but another identity: a new build
    same_values = shard.replicate(mesh, torch.zeros(4, 2))
    assert not shard._same_key(key, shard._pose_key(
        pos, CAM_A.basis(), (same_values,) + env[1:]))
    assert not shard._same_key(key, shard._pose_key(pos, CAM_A.basis(),
                                                    env[:3]))
    assert not shard._same_key(key, shard._pose_key(pos, CAM_A.basis(),
                                                    (E, 2.0, 1.25, 256)))
    assert not shard._same_key(key, None) and not shard._same_key(None, None)


class _Closable:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_the_first_call_with_a_new_key_runs_eagerly():
    cache = shard._GraphCache()
    made = []

    def capture():
        made.append(_Closable())
        return made[-1]

    a = shard._pose_key(np.zeros(3, np.float32), torch.eye(3), ())
    b = shard._pose_key(np.ones(3, np.float32), torch.eye(3), ())
    assert cache.get(a, capture) is None and not made  # first: eager
    g = cache.get(a, capture)  # second in a row: captured
    assert g is made[0] and cache.get(a, capture) is g and len(made) == 1
    assert cache.get(b, capture) is None and g.closed  # a new key drops
    assert cache.get(a, capture) is None and len(made) == 1  # not in a row
    assert cache.get(a, capture) is made[1]
    assert cache.get(None, capture) is None and made[1].closed
    assert cache.get(None, capture) is None and len(made) == 2


def test_a_cpu_mesh_never_captures_and_runs_eagerly(monkeypatch):
    r = _renderer([torch.device("cpu", i) for i in range(4)])
    calls = []
    run = shard.run_shards
    monkeypatch.setattr(shard, "run_shards",
                        lambda mesh, fn: calls.append(1) or run(mesh, fn))
    for _ in range(3):
        r.sample(CAM_A, SUN)
    step = r._dist_step
    assert len(calls) == 3 and step.graphs.graphs is None
    assert step.graphs.key is None


class _FakeGraphs(shard._CardGraphs):
    """``_CardGraphs`` without a card: its own ``replay`` over stand-in
    graphs, each of which runs its entry's ``render_sample`` eagerly
    from the entry's int64 seed buffer, the sun buffer and the pose the
    capture was handed."""

    made = []

    def __init__(self, mesh, world, cam_pos, cam_basis, env, seeds, sun):
        self.mesh = mesh
        self.sun = torch.zeros(3)
        self.seed = [torch.zeros(3, dtype=torch.int64) for _ in mesh.devices]
        self.out = [None] * mesh.size
        self.launched = [{} for _ in mesh.devices]
        self.graph = [types.SimpleNamespace(replay=functools.partial(
            self._sample, i, world.kw(d, torch.as_tensor(cam_pos), cam_basis,
                                      self.sun, None, env, None)))
            for i, d in enumerate(mesh.devices)]
        self.replays, self.reads, self.closed = 0, 0, False
        _FakeGraphs.made.append(self)

    def _sample(self, i, kw):
        self.out[i] = integrator.render_sample(frame_seed=self.seed[i], **kw)

    def _stage(self, seeds, sun):
        self.replays += 1
        self.sun.copy_(sun)
        return torch.from_numpy(seeds.astype(np.int64))

    def read_done(self):
        self.reads += 1

    def close(self):
        self.closed = True


def _fake_graphs(monkeypatch, mesh):
    """Stand-in graphs for ``mesh``'s steps; returns the flags of every
    ``run_shards`` call on ``mesh``: True for a replay."""
    graphable = shard._graphable
    monkeypatch.setattr(shard, "_graphable",
                        lambda m, *a: m is mesh or graphable(m, *a))
    monkeypatch.setattr(shard, "_CardGraphs", _FakeGraphs)
    _FakeGraphs.made = []
    runs = []
    run = shard.run_shards
    monkeypatch.setattr(shard, "run_shards", lambda m, fn: (
        m is mesh and runs.append(getattr(fn, "graphed", False))
        or run(m, fn)))
    return runs


def test_graphed_steps_follow_the_key_and_equal_eager_steps(monkeypatch):
    """With a stand-in for the graphs on a CPU mesh: the first step of a
    pose runs eagerly, the second captures and replays, and so on; a new
    pose, and the new step object after ``apply_edits``, start again;
    every step equals the same Renderer run eagerly, by bits."""
    spaces = [_space(), _space()]
    r = _renderer(["cpu"] * 3, space=spaces[0])
    eager = _renderer(["cpu"] * 3, space=spaces[1])
    runs = _fake_graphs(monkeypatch, r.mesh)

    def both(cam, sun=SUN):
        r.sample(cam, sun)
        eager.sample(cam, sun)
        assert torch.equal(r.acc.buffer, eager.acc.buffer)

    def seen():  # (eager steps of r, graphs made, replays of the last)
        made = _FakeGraphs.made
        return (runs.count(False), len(made),
                made[-1].replays if made else 0)

    both(CAM_A)
    assert seen() == (1, 0, 0)
    both(CAM_A)
    assert seen() == (1, 1, 1)
    both(CAM_A, SUN * [1.0, 0.5, 1.0])  # a new sun: replayed all the same
    assert seen() == (1, 1, 2) and _FakeGraphs.made[0].reads == 2
    both(CAM_B)
    assert seen() == (2, 1, 2) and _FakeGraphs.made[0].closed
    both(CAM_B)
    assert seen() == (2, 2, 1)
    first = r._dist_step
    for space, rr in zip(spaces, (r, eager)):
        p = (12, int(space.heights[12, 6]) - 1, 6)
        space.set(p, None)
        rr.apply_edits(space, edits=[p])
    both(CAM_B)
    assert r._dist_step is not first and seen() == (3, 2, 1)
    both(CAM_B)
    assert seen() == (3, 3, 1)
    assert r.acc.samples == 6


def test_a_traced_replayed_step_counts_its_replays_through_run_shards(
        monkeypatch):
    """With the stand-in graphs on four distinct CPU devices: while
    profiling, an eager step counts each card's call and no replay, a
    replayed step a call and a replay a card, each in ``vt:shard`` under
    ``vt:shards``, through ``run_shards``."""
    r = _renderer([torch.device("cpu", i) for i in range(4)])
    runs = _fake_graphs(monkeypatch, r.mesh)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r.sample(CAM_A, SUN)  # eager
    c = _shard_counts()
    assert runs == [False]
    assert {c[f"shard.calls.{k}"] for k in range(4)} == {1}
    assert {c[f"shard.graph_replays.{k}"] for k in range(4)} == {0}
    r.sample(CAM_A, SUN)  # captured and replayed, not profiled
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.sample(CAM_A, SUN)  # replayed
    c = _shard_counts()
    assert runs == [False, True, True] and _FakeGraphs.made[0].replays == 2
    assert len(c) == 12
    assert {c[f"shard.calls.{k}"] for k in range(4)} == {1}
    assert {c[f"shard.graph_replays.{k}"] for k in range(4)} == {1}
    assert sorted(e.cpu_parent.name for e in prof.events()
                  if e.name == "vt:shard") == ["vt:shards"] * 4
    profiling.reset()


def test_a_tensor_seed_and_pose_give_the_numpy_forms_sample():
    """``render_sample`` with its seed, pose and terrain colour as tensors
    (the graphs' form) gives the numpy forms' radiance by bits, and
    ``seed_pixels`` takes only an int64 seed on the pixels' device."""
    r = _renderer(None, hf_only=True)
    tiles, offs, trgb = r._get_hf()
    w = r.world
    seed = np.array([4000000000, 7, 123456789], np.uint32)
    sun = torch.from_numpy((SUN / np.linalg.norm(SUN)).astype(np.float32))
    kw = dict(hf_mips=tiles, hf_offsets=offs, hf_sky_env=r._get_sky_env(
        CAM_A), **KW)
    want = integrator.render_sample(
        w.table, w.root, w.height, r.lut, np.asarray(CAM_A.pos, np.float32),
        CAM_A.basis(), sun, seed, W, H, terrain_rgb=tuple(trgb.tolist()),
        **kw)
    got = integrator.render_sample(
        w.table, w.root, w.height, r.lut,
        torch.tensor(CAM_A.pos, dtype=torch.float32), CAM_A.basis(), sun,
        torch.from_numpy(seed.astype(np.int64)), W, H, terrain_rgb=trgb,
        **kw)
    assert torch.equal(got, want)
    px = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        vrng.seed_pixels(torch.from_numpy(seed.astype(np.int32)), px, px)


def test_recording_diverts_this_threads_counts_and_drops_its_holds():
    profiling.reset()
    other = threading.Thread(target=profiling.count, args=("launches.x", 5))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.recording() as sink:
            profiling.count("launches.x")
            profiling.count("launches.y", 2)
            profiling.hold("k9.queued", ("live",), torch.ones(2, 1))
            other.start()
            other.join()
        profiling.count("launches.y")
    assert sink == {"launches.x": 1, "launches.y": 2}
    assert profiling.counts() == {"launches.x": 5, "launches.y": 1}
    profiling.reset()


# -- the readers --

def _run():
    ev = trace.Events([dict(ph="X", name=trace.WINDOW, ts=0, dur=1000,
                            cat="user_annotation")], 8)
    return bench.Run(events=ev)


def _read(metric, run):
    return bench.metric_reader(metric)(run)


def _profiled(cards):
    """The registry as a step leaves it while the caller profiles:
    ``cards`` is ``{card: (calls, replays, captures, host us a call)}``."""
    profiling.reset()
    for k, (calls, replays, captures, us) in cards.items():
        profiling.count(f"shard.calls.{k}", calls)
        profiling.count(f"shard.host_us.{k}", calls * us)
        profiling.count(f"shard.graph_replays.{k}", replays)
        if captures:
            profiling.count(f"shard.graph_captures.{k}", captures)


def test_share_and_host_readers_read_a_graphed_registry(capsys):
    _profiled({0: (40, 40, 0, 150), 1: (40, 40, 0, 130),
               2: (40, 38, 1, 170), 3: (40, 40, 0, 150)})
    assert _read("shard_graph_share.x4", _run()) == pytest.approx(158 / 160)
    assert _read("shard_host_ms.x4", _run()) == pytest.approx(0.15)
    err = capsys.readouterr().err
    assert "card 2: 38 replays of 40 calls, 1 captures" in err
    assert "card 1: 40 calls, 0.1300 ms a call" in err
    _profiled({0: (10, 0, 0, 9000)})  # every call eager
    assert _read("shard_graph_share.x4", _run()) == 0.0
    profiling.reset()


def test_share_reader_gives_none_without_the_counts(monkeypatch):
    """No shard counted, an untraced run, a program that counts its
    shard calls but no replays (no graphs), and one whose profiling
    module has no registry."""
    profiling.reset()
    profiling.count("launches.path_trace", 3)
    assert _read("shard_graph_share.x4", _run()) is None
    _profiled({0: (4, 4, 0, 100)})
    assert _read("shard_graph_share.x4", bench.Run(events=None)) is None
    profiling.reset()
    profiling.count("shard.calls.0", 4)
    profiling.count("shard.host_us.0", 4000)
    assert _read("shard_graph_share.x4", _run()) is None
    assert _read("shard_host_ms.x4", _run()) == pytest.approx(1.0)
    monkeypatch.setitem(sys.modules, "voxtracer_torch.utils.profiling",
                        types.ModuleType("voxtracer_torch.utils.profiling"))
    assert _read("shard_graph_share.x4", _run()) is None
    profiling.reset()


# -- on a card --

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda", 0)


def _cards(cuda, layout):
    if layout == "one-card":
        return [cuda] * 4
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    return [torch.device("cuda", i) for i in range(4)]


def _unit(sun):
    return torch.from_numpy((sun / np.linalg.norm(sun)).astype(np.float32))


@pytest.mark.parametrize("layout", ["one-card", "four-cards"])
def test_graphed_step_equals_the_serial_sum_by_bits(cuda, layout):
    """Seven steps: pose A (eager, captured, replayed, then a new sun),
    pose B (eager, captured, replayed); each the serial mesh-order sum of
    eager ``render_sample`` calls with its seeds, by bits."""
    devices = _cards(cuda, layout)
    mesh = vmesh.make_mesh(devices=devices)
    r = _renderer(devices, hf_only=True)
    tiles, offs, trgb = r._get_hf()
    w = r.world
    step = shard.sample_sharded_step(mesh, w.table, w.root, w.height, r.lut,
                                     W, H, hf_mips=tiles, hf_offsets=offs,
                                     terrain_rgb=trgb, **KW)
    envs = {}
    for cam in (CAM_A, CAM_B):
        env = r._get_sky_env(cam)
        envs[id(cam)] = (env, tuple(shard.replicate(mesh, a)
                                    if torch.is_tensor(a) else a for a in env))
    rep = {d: [shard.replicate(mesh, x).on(d) for x in (w.table, r.lut,
                                                         tiles, trgb)]
           for d in mesh.distinct}
    rng = np.random.default_rng(22)
    plan = [(CAM_A, SUN, None), (CAM_A, SUN, "capture"),
            (CAM_A, SUN, "replay"), (CAM_A, SUN * [1.0, 0.4, 1.2], "replay"),
            (CAM_B, SUN, None), (CAM_B, SUN, "capture"),
            (CAM_B, SUN, "replay")]
    graphs = []
    for cam, sun, mode in plan:
        seeds = rng.integers(0, 2 ** 32, (4, 3), dtype=np.uint64) \
            .astype(np.uint32)
        pos, basis = np.asarray(cam.pos, np.float32), cam.basis()
        env, env_r = envs[id(cam)]
        got = step(seeds, pos, basis, _unit(sun).to(cuda), *env_r)
        want = None
        for i, d in enumerate(devices):
            table, lut, t, rgb = rep[d]
            part = integrator.render_sample(
                table, w.root, w.height, lut, pos, basis, _unit(sun).to(d),
                seeds[i], W, H, hf_mips=t, hf_offsets=offs, terrain_rgb=rgb,
                hf_sky_env=tuple(shard.replicate(mesh, a).on(d)
                                 if torch.is_tensor(a) else a for a in env),
                **KW)
            want = part if want is None else want + part.to(devices[0])
        assert got.device == devices[0]
        assert torch.equal(got, want), (cam, mode)
        g = step.graphs.graphs
        assert (g is None) == (mode is None)
        if mode == "capture":
            graphs.append(g)
        elif mode == "replay":
            assert g is graphs[-1]
    assert len(graphs) == 2 and graphs[0] is not graphs[1]
    assert len({id(o) for o in graphs[1].out}) == 4  # an output an entry


@pytest.mark.parametrize("layout", ["one-card", "four-cards"])
def test_graphed_steps_without_a_host_sync_equal_the_serial_sum(cuda,
                                                                layout):
    """A Renderer's steps at a held pose, warmed past the envelope's last
    tier and captured, then four replays under sync-debug "error" with
    the sun changed after the second: nothing on the host waits for the
    cards, and each step equals the serial mesh-order sum of eager
    ``render_sample`` calls with its seeds, synchronised, by bits, and the
    accumulation the sum of the steps since the sun changed."""
    devices = _cards(cuda, layout)
    mesh = vmesh.make_mesh(devices=devices)
    r = _renderer(devices, hf_only=True)
    for _ in range(7):  # tiers 0, 1, 2 (first uses 0, 1, 4), each captured
        r.sample(CAM_A, SUN * [1.0, 0.7, 1.0])
    step = r._dist_step
    graphs = step.graphs.graphs
    assert graphs is not None
    calls = []

    def spy(seeds, *a, **k):
        total = step(seeds, *a, **k)
        calls.append((seeds.copy(), total))
        return total

    r._dist_step = spy
    plan = [SUN, SUN, SUN * [1.0, 0.4, 1.2], SUN * [1.0, 0.4, 1.2]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sun in plan:
            r.sample(CAM_A, sun)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert step.graphs.graphs is graphs and len(calls) == 4
    tiles, offs, trgb = r._get_hf()
    w = r.world
    env = r._sky_env[1]
    pos, basis = np.asarray(CAM_A.pos, np.float32), CAM_A.basis()
    totals = []
    for (seeds, got), sun in zip(calls, plan):
        want = None
        for i, d in enumerate(devices):
            table, lut, t, rgb = (shard.replicate(mesh, x).on(d)
                                  for x in (w.table, r.lut, tiles, trgb))
            part = integrator.render_sample(
                table, w.root, w.height, lut, pos, basis, _unit(sun).to(d),
                seeds[i], W, H, hf_mips=t, hf_offsets=offs, terrain_rgb=rgb,
                hf_sky_env=tuple(shard.replicate(mesh, a).on(d)
                                 if torch.is_tensor(a) else a for a in env),
                **KW)
            torch.cuda.synchronize()
            want = part if want is None else want + part.to(devices[0])
        assert torch.equal(got, want)
        totals.append(want)
    acc = totals[2].clone()
    acc += totals[3]
    assert r.acc.samples == 8 and torch.equal(r.acc.buffer, acc)


def test_the_step_after_apply_edits_captures_again(cuda, monkeypatch):
    """A Renderer on one card repeated twice against the same Renderer
    held eager: equal by bits through a capture, ``apply_edits`` (a new
    step object, eager first) and its own capture."""
    spaces = [_space(), _space()]
    r = _renderer([cuda] * 2, space=spaces[0])
    eager = _renderer([cuda] * 2, space=spaces[1])
    graphable = shard._graphable
    monkeypatch.setattr(shard, "_graphable", lambda mesh, *a: (
        mesh is not eager.mesh and graphable(mesh, *a)))
    steps = []
    for n in range(5):
        if n == 2:
            for space, rr in zip(spaces, (r, eager)):
                p = (12, int(space.heights[12, 6]) - 1, 6)
                space.set(p, None)
                rr.apply_edits(space, edits=[p])
        r.sample(CAM_A, SUN)
        eager.sample(CAM_A, SUN)
        assert torch.equal(r.acc.buffer, eager.acc.buffer), n
        steps.append((r._dist_step, r._dist_step.graphs.graphs))
    assert [g is None for _, g in steps] == [True, False, True, False,
                                             False]
    assert steps[2][0] is not steps[1][0] and steps[3][0] is steps[2][0]
    assert eager._dist_step.graphs.graphs is None


def test_a_soup_step_stays_eager(cuda):
    r = _renderer([cuda] * 2, use_soup=True)
    for _ in range(3):
        r.sample(CAM_A, SUN)
    assert r._dist_soup is not None
    assert r._dist_step.graphs.graphs is None
    assert r._dist_step.graphs.key is None


def _launches():
    return {k: v for k, v in profiling.counts().items()
            if k.startswith("launches.")}


def test_the_counters_read_what_ran(cuda):
    """Three steps while profiling on one card repeated three times, the
    first with the envelope's last tier (eager), then captured, then
    replayed: captures, replays and calls by card, and the launches: a
    sample's each step (K5, K4, K9), one more a capture's warm call, and
    the tier's envelope build."""
    r = _renderer([cuda] * 3, hf_only=True)
    for _ in range(4):  # tiers 0 and 1; the second captured, replayed
        r.sample(CAM_A, SUN)
    assert r._dist_step.graphs.graphs is not None
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            r.sample(CAM_A, SUN)
    torch.cuda.synchronize()
    c = _shard_counts()
    assert c == {"shard.calls.0": 9, "shard.graph_replays.0": 6,
                 "shard.graph_captures.0": 3,
                 "shard.host_us.0": c["shard.host_us.0"]}
    # three eager samples, three warm calls, six replays
    assert _launches() == {"launches.path_trace": 12, "launches.hf_cast": 12,
                           "launches.sky_tmin": 12, "launches.env_build": 1}
    profiling.reset()
