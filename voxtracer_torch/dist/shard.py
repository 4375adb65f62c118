"""Multi-device render steps over a mesh (the counterpart of
``voxtracer/dist/shard.py``'s ``shard_map`` steps).

Two strategies:

* **sample sharding**: every mesh entry traces the whole frame with its
  own seed; the shards' radiance is summed in mesh order onto the mesh's
  first device (the psum's counterpart), then, when the mesh has a process
  group, ``all_reduce(SUM)`` across processes. The fixed order makes the
  in-process step equal by bits to the serial sum ``s0 + s1 + ...`` of the
  same ``render_sample`` calls.
* **tile sharding**: entry i (global shard index ``rank * size + i``)
  renders the rows ``[i * rows, (i + 1) * rows)``, ``rows = ceil(H / n)``;
  the bands are concatenated (gathered across processes) into a frame of
  ``step.out_rows`` rows, which the caller crops to H.

The world (node table, LUT, soup, heightfield pack) is read-only and
closes over a step with one copy on each distinct device of the mesh
(``replicate_world``); a repeated device shares its copy. Per-pose
accelerators ride a step as call args: the culled soup view
(``dynamic_soup``), the horizon envelope ``(E, d0, g[, K, S])`` and the
pose's jittered raster bins (``soup_bins=``). A call arg given as a
``Replicated`` is used as it is; a tensor is copied to each distinct
device on every call, so the Renderer replicates them once per pose.

Every shard call of both steps, eager or a graph replay, runs in one
loop (``run_shards``): in mesh order from the caller's thread, a card's
call under its device context. On four H100s at 8192^3 a step's eager
calls took 13.70-14.41 ms so, against 50.29-59.36 ms from a host thread
a card.

**CUDA graphs.** A sample-sharded step whose shards read nothing from the
host (every device a card, no soup: closed over, dynamic or its bins)
runs each mesh entry's ``render_sample`` as a CUDA graph of its own,
replayed through that loop: no Python around the ~290 launches of a
sample, no pageable upload. A graph bakes in the step's world and what
the capture key holds (``_pose_key``): the pose's bytes and the per-pose
call args (the envelope) by identity. The first call with a key runs
eagerly; a second call in a row with the same key captures (an eager
warm call first, then the capture into a memory pool a card) and
replays, and so does every later one; a new key drops the graphs. A
pose that changes every call (an interactive session on several cards)
therefore never pays for a capture. What changes from call to call
lives in fixed device buffers: each entry's frame seed and each card's
sun, written before the replays by non-blocking copies (the seeds from
pinned host memory, whose caching allocator hands a block out again
only once the copies that read it have run; the sun from the caller's
tensor, which the Renderer hands over on the first card). Before a
card's buffers and graph outputs are written again, its stream waits
for an event recorded after the last call's sum read them. The sum
stays in mesh order, so a graphed step equals the eager step, and the
serial sum, by bits.

What sharding adds is named in the port's trace: ``vt:shards`` around
the shard calls and ``vt:shard_sum`` around the cross-card sum (the
copies onto the first device, the mesh-order adds, the ``all_reduce``).
``run_shards`` reads once a call whether the profiler records
(``torch.autograd._profiler_enabled()``). While it does, each shard call
runs in ``vt:shard`` and counts for the k-th distinct device
``shard.calls.<k>``, ``shard.host_us.<k>`` (the call's host
microseconds: a replay's are its seed's copy and the launch) and
``shard.graph_replays.<k>`` (1 for a replay, 0 for an eager call); a
capture counts ``shard.graph_captures.<k>``. A replay adds to
``launches.<kernel>`` what its capture launched; K9's per-bounce queue
lengths (``k9.queued``) are held for eager calls only. Untraced, the
loop reads no clock and takes no lock.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from voxtracer_torch.kernels.integrator import render_sample
from voxtracer_torch.utils import profiling
from voxtracer_torch.utils.profiling import span


class Replicated:
    """One copy of a read-only value (a tensor, or a tuple or dict of
    them) on each distinct device of a mesh."""

    def __init__(self, copies: dict):
        self.copies = copies

    def on(self, device):
        return self.copies[torch.device(device)]


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(a, dev) for a in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def replicate(mesh, x) -> Replicated:
    """``x`` on each distinct device of ``mesh``; a tensor already on one
    of them is used there without a copy. A ``Replicated`` passes."""
    if isinstance(x, Replicated):
        return x
    return Replicated({d: _to(x, d) for d in mesh.distinct})


def replicate_world(mesh, table, lut, soup=None, hf_mips=None):
    """Pin the read-only world and LUT (and the box soup and heightfield
    pack when given) to every distinct device of ``mesh``: ``(table, lut[,
    soup][, hf_mips])`` as ``Replicated`` values, which the steps take in
    place of tensors."""
    out = (replicate(mesh, table), replicate(mesh, lut))
    if soup is not None:
        out += (replicate(mesh, tuple(soup)),)
    if hf_mips is not None:
        out += (replicate(mesh, hf_mips),)
    return out


def _device_ctx(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def run_shards(mesh, fn):
    """``[fn(i, device) for each mesh entry i]`` in mesh order, from the
    caller's thread, a card's call under its device context. While the
    profiler records, each call runs in ``vt:shard`` and is counted as
    its distinct device's; ``fn.graphed`` marks the calls as graph
    replays (module doc)."""
    traced = torch.autograd._profiler_enabled()
    if traced:
        card = {d: k for k, d in enumerate(mesh.distinct)}
        graphed = int(getattr(fn, "graphed", False))
    out = []
    for i, dev in enumerate(mesh.devices):
        with _device_ctx(dev):
            if not traced:
                out.append(fn(i, dev))
                continue
            with torch.autograd.profiler.record_function("vt:shard"):
                t = time.perf_counter_ns()
                out.append(fn(i, dev))
                us = (time.perf_counter_ns() - t) // 1000
        k = card[dev]
        profiling.count(f"shard.host_us.{k}", us)
        profiling.count(f"shard.calls.{k}")
        profiling.count(f"shard.graph_replays.{k}", graphed)
    return out


def _call_args(mesh, extra, dynamic_soup: bool):
    """The per-pose call args ``(soup view or None, envelope or None)``,
    each replicated over the mesh."""
    extra = [replicate(mesh, a) if isinstance(a, (torch.Tensor, Replicated))
             else a for a in extra]
    dyn = None
    if dynamic_soup:
        if len(extra) < 3:
            raise ValueError("dynamic_soup: the step takes (soup_lo, "
                             "soup_size, soup_attr) after the sun")
        dyn, extra = extra[:3], extra[3:]
    return dyn, (extra or None)


def _on(x, dev):
    return x.on(dev) if isinstance(x, Replicated) else x


class _World:
    """A step's closed-over world, replicated over the mesh, as
    ``render_sample``'s keywords on one device."""

    def __init__(self, mesh, table, root: int, height: int, lut, width_px,
                 height_px, max_bounces, fog_steps, soup, hf_mips,
                 hf_offsets, terrain_rgb):
        self.table = replicate(mesh, table)
        self.lut = replicate(mesh, lut)
        self.soup = None if soup is None else replicate(
            mesh, soup if isinstance(soup, Replicated) else tuple(soup))
        self.hf = None if hf_mips is None else (
            replicate(mesh, hf_mips), replicate(mesh, terrain_rgb))
        self.fixed = dict(root=root, height=height, width_px=width_px,
                          height_px=height_px, max_bounces=max_bounces,
                          fog_steps=fog_steps, hf_offsets=hf_offsets)

    def kw(self, dev, cam_pos, cam_basis, sun, dyn, env, soup_bins):
        if dyn is not None:
            soup = tuple(_on(a, dev) for a in dyn)
        else:
            soup = None if self.soup is None else self.soup.on(dev)
        kw = dict(self.fixed, table=self.table.on(dev), lut=self.lut.on(dev),
                  cam_pos=cam_pos, cam_basis=cam_basis, sun=_on(sun, dev),
                  soup=soup,
                  soup_bins=None if soup_bins is None else soup_bins.on(dev))
        if self.hf is not None:
            kw.update(hf_mips=self.hf[0].on(dev),
                      terrain_rgb=self.hf[1].on(dev),
                      hf_sky_env=None if env is None
                      else tuple(_on(a, dev) for a in env))
        return kw


def _graphable(mesh, world, dynamic_soup: bool, soup_bins) -> bool:
    """Whether a sample-sharded call may run as CUDA graphs: every device
    of the mesh is a card and no soup is in it (module doc)."""
    return (world.soup is None and not dynamic_soup and soup_bins is None
            and all(d.type == "cuda" for d in mesh.distinct))


def _pose_key(cam_pos, cam_basis, extra) -> tuple:
    """What a call's graphs bake in besides the step's world: the pose's
    float32 bytes and the call args (the envelope), these by identity
    (``_same_key``)."""
    def raw(x):
        return torch.as_tensor(x, dtype=torch.float32).cpu().numpy().tobytes()

    return raw(cam_pos), raw(cam_basis), tuple(extra)


def _same_key(a, b) -> bool:
    if a is None or b is None or a[:2] != b[:2] or len(a[2]) != len(b[2]):
        return False
    return all(x is y or (not isinstance(x, (torch.Tensor, Replicated))
                          and type(x) is type(y) and x == y)
               for x, y in zip(a[2], b[2]))


class _GraphCache:
    """A sample-sharded step's graphs and the key they were captured for:
    graphs on the second call in a row with one key, none on the first
    (module doc)."""

    def __init__(self):
        self.key = self.graphs = None

    def get(self, key, capture):
        """The graphs for ``key`` (``capture()`` makes them on its second
        call in a row), or None: run eagerly. A new key (None: not
        graphable) drops the old graphs."""
        if not _same_key(key, self.key):
            if self.graphs is not None:
                self.graphs.close()
            self.key, self.graphs = key, None
            return None
        if self.graphs is None:
            self.graphs = capture()
        return self.graphs


class _CardGraphs:
    """Each mesh entry's ``render_sample`` on its card as a CUDA graph of
    its own, captured for one pose (module doc); entries on one card share
    its memory pool, its sun and its pose."""

    def __init__(self, mesh, world, cam_pos, cam_basis, env, seeds, sun):
        self.mesh = mesh
        self.card = {d: k for k, d in enumerate(mesh.distinct)}
        f32 = torch.float32
        # kw: each card's arguments, kept, since the graphs read their
        # tensors (the pose made here, the envelope's replicas)
        self.sun, self.read, self.kw = {}, {}, {}
        kw = self.kw
        pool, side = {}, {}
        for d in mesh.distinct:
            with torch.cuda.device(d):
                self.sun[d] = torch.zeros(3, dtype=f32, device=d)
                self.read[d] = torch.cuda.Event()
                pool[d] = torch.cuda.graph_pool_handle()
                side[d] = torch.cuda.Stream(d)
                # the pose on the card, made before any capture
                kw[d] = world.kw(
                    d, torch.as_tensor(cam_pos, dtype=f32).to(d),
                    torch.as_tensor(cam_basis, dtype=f32).to(d), self.sun[d],
                    None, env, None)
        self.seed = [torch.zeros(3, dtype=torch.int64, device=d)
                     for d in mesh.devices]
        host = self._stage(seeds, sun)
        traced = torch.autograd._profiler_enabled()
        self.graph, self.out, self.launched = [], [], []
        for i, d in enumerate(mesh.devices):
            self.seed[i].copy_(host[i], non_blocking=True)
            with torch.cuda.device(d):
                # warm: the per-card caches (row starts, the kernel
                # library) fill outside the capture
                render_sample(frame_seed=self.seed[i], **kw[d])
                g = torch.cuda.CUDAGraph()
                with profiling.recording() as launched, \
                        torch.cuda.graph(g, pool=pool[d], stream=side[d]):
                    out = render_sample(frame_seed=self.seed[i], **kw[d])
            self.graph.append(g)
            self.out.append(out)
            self.launched.append(launched)
            if traced:
                profiling.count(f"shard.graph_captures.{self.card[d]}")

    def _stage(self, seeds, sun):
        """Write each card's sun, after its stream has waited for the last
        call's sum; the seeds in pinned host memory for ``replay``."""
        for d in self.mesh.distinct:
            with torch.cuda.device(d):
                torch.cuda.current_stream().wait_event(self.read[d])
                self.sun[d].copy_(sun, non_blocking=True)
        return torch.from_numpy(seeds.astype(np.int64)).pin_memory()

    def replay(self, seeds, sun):
        """The entries' radiance for this call's seeds and sun, in mesh
        order: each graph's own output, valid until the next call."""
        host = self._stage(seeds, sun)

        def call(i, dev):
            self.seed[i].copy_(host[i], non_blocking=True)
            self.graph[i].replay()
            for name, n in self.launched[i].items():
                profiling.count(name, n)
            return self.out[i]

        call.graphed = True
        return run_shards(self.mesh, call)

    def read_done(self):
        """Mark each card's stream after the sum's reads of the outputs."""
        for d in self.mesh.distinct:
            with torch.cuda.device(d):
                self.read[d].record()

    def close(self):
        """Wait for every card before the graphs and their pools go."""
        for d in self.mesh.distinct:
            torch.cuda.synchronize(d)
        self.graph = self.out = None


def _check_soup(soup, dynamic_soup: bool):
    if dynamic_soup and soup is not None:
        raise ValueError("dynamic_soup replaces the closed-over soup")


def sample_sharded_step(mesh, table, root: int, height: int, lut,
                        width_px: int, height_px: int, max_bounces: int = 8,
                        fog_steps: int = 64, soup=None, hf_mips=None,
                        hf_offsets: tuple | None = None, terrain_rgb=None,
                        dynamic_soup: bool = False):
    """Build a step ``(seeds (size, 3) uint32, cam_pos, cam_basis, sun,
    *extra, soup_bins=None) -> the radiance (H, W, 3) summed over every
    shard``, on the mesh's first device (every process holds the same sum).

    ``seeds``: this process's rows, one per mesh entry
    (``multihost.global_seeds``). ``soup``: (box_lo, box_size, box_attr),
    rasterized primaries on every shard. ``hf_mips``/``hf_offsets``/
    ``terrain_rgb``: the heightfield engine on every shard (an unedited
    world's: the step takes no edit bounds). ``dynamic_soup``: the soup
    is no closure but the first three call args after the sun (the
    pose's culled view); the remaining call args are the envelope, taken
    by the hf-only primaries. ``soup_bins``: the pose's jittered
    ``raster_bins`` of the soup the shards rasterize (a ``Replicated``,
    or one device's, copied per call). On cards without a soup the step
    replays CUDA graphs once a key repeats (module doc); ``step.graphs``
    holds them."""
    _check_soup(soup, dynamic_soup)
    world = _World(mesh, table, root, height, lut, width_px, height_px,
                   max_bounces, fog_steps, soup, hf_mips, hf_offsets,
                   terrain_rgb)
    graphs = _GraphCache()

    def step(seeds, cam_pos, cam_basis, sun, *extra, soup_bins=None):
        seeds = np.asarray(seeds, np.uint32).reshape(-1, 3)
        if seeds.shape[0] != mesh.size:
            raise ValueError(f"sample_sharded_step: {seeds.shape[0]} seed "
                             f"rows for {mesh.size} shards")
        key = _pose_key(cam_pos, cam_basis, extra) if _graphable(
            mesh, world, dynamic_soup, soup_bins) else None
        with span("vt:shards"):
            g = graphs.get(key, lambda: _CardGraphs(
                mesh, world, cam_pos, cam_basis,
                _call_args(mesh, extra, False)[1], seeds, sun))
            if g is not None:
                parts = g.replay(seeds, sun)
            else:
                dyn, env = _call_args(mesh, extra, dynamic_soup)
                bins = None if soup_bins is None \
                    else replicate(mesh, soup_bins)
                sun_r = replicate(mesh, sun)
                parts = run_shards(mesh, lambda i, dev: render_sample(
                    frame_seed=seeds[i], **world.kw(
                        dev, cam_pos, cam_basis, sun_r, dyn, env, bins)))
        with span("vt:shard_sum"):
            first = mesh.devices[0]
            # a graph's output is its own: the caller gets a new tensor
            total = parts[0] if g is None or len(parts) > 1 \
                else parts[0].clone()
            for p in parts[1:]:
                total = total + p.to(first)
            if g is not None:
                g.read_done()
            if mesh.group is not None:
                import torch.distributed as dist

                dist.all_reduce(total, op=dist.ReduceOp.SUM,
                                group=mesh.group)
        return total

    step.graphs = graphs
    return step


def tile_sharded_step(mesh, table, root: int, height: int, lut,
                      width_px: int, height_px: int, max_bounces: int = 8,
                      fog_steps: int = 64, soup=None, hf_mips=None,
                      hf_offsets: tuple | None = None, terrain_rgb=None,
                      dynamic_soup: bool = False):
    """Build a step ``(seed (3,) uint32, cam_pos, cam_basis, sun, *extra,
    soup_bins=None) -> (step.out_rows, W, 3)``: every shard renders its
    band of ``ceil(H / n)`` rows of the same full-frame sample, n the
    shards over every process; crop ``[:height_px]``. With a soup each
    band rasterizes its TILE-aligned run of rows against the full-frame
    pose bins (``render_sample(row0=, rows=)``); the padded bands must
    then fit the tile-padded frame, else this raises (use sample
    sharding). Arguments and call args as ``sample_sharded_step``.

    Across processes the bands are all-gathered; with the gloo backend
    the frame crosses through the host, since gloo gathers no CUDA
    tensors."""
    _check_soup(soup, dynamic_soup)
    ndev = mesh.global_size
    # remainder band: every shard renders ceil(H/n) rows of the same
    # full-frame camera mapping; the soup's banded resolve slices from the
    # tile-padded frame, so the padded total must fit it
    rows = -(-height_px // ndev)
    if rows * ndev > max(height_px, -(-height_px // 8) * 8) \
            and (soup is not None or dynamic_soup):
        raise ValueError(
            f"tile sharding cannot pad {height_px} rows over {ndev} "
            f"shards with a soup (padded {rows * ndev} rows exceed the "
            f"tile-padded frame); use sample sharding")
    world = _World(mesh, table, root, height, lut, width_px, height_px,
                   max_bounces, fog_steps, soup, hf_mips, hf_offsets,
                   terrain_rgb)

    def step(seed, cam_pos, cam_basis, sun, *extra, soup_bins=None):
        seed = np.asarray(seed, np.uint32).reshape(3)
        dyn, env = _call_args(mesh, extra, dynamic_soup)
        bins = None if soup_bins is None else replicate(mesh, soup_bins)
        sun_r = replicate(mesh, sun)
        base = mesh.rank * mesh.size
        with span("vt:shards"):
            parts = run_shards(mesh, lambda i, dev: render_sample(
                frame_seed=seed, row0=(base + i) * rows, rows=rows,
                **world.kw(dev, cam_pos, cam_basis, sun_r, dyn, env, bins)))
        first = mesh.devices[0]
        frame = torch.cat([p.to(first) for p in parts])
        if mesh.group is not None:
            frame = _all_gather(frame, mesh.group)
        return frame

    step.out_rows = rows * ndev
    return step


def _all_gather(t, group):
    """The ranks' ``t`` stacked along rows, in rank order."""
    import torch.distributed as dist

    stage = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = t.cpu() if stage else t
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return torch.cat(outs).to(t.device)
