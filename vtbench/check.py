"""The check that decides ``correct``: what the timed path produced,
compared with the plain reference (``vtbench/reference/``) on the same
inputs, after the window has closed and the program's state is freed.

* headless cells: one frame of the window, drawn from the seed, as its
  EXR holds it (the accumulator's mean over the frame's samples, the
  four-card sum included), at ``pixels`` pixels drawn from the seed;
  the reference traces every sample of that frame at those pixels with
  the frame seeds the Renderer drew, sums them as the program documents
  (sample by sample; with a mesh, each step's samples in mesh order,
  then into the sum), and divides.
* session cells: up to ``actions`` of the window's actions, drawn from
  the seed with the last among them: the preview the host received, at
  ``preview_pixels`` pixels; the accumulation after the action's
  samples, at ``sample_pixels`` pixels; and with edits the pick under the
  crosshair. The reference builds the world of each action from the
  heightmap and the edits made before it.

Numbers compared (each against a limit from the cell's traffic file):

* ``frame_l1``: sum |program - reference| / sum |reference| over the
  frame's checked pixels and channels;
* ``frame_px_max``: the largest |program - reference| of a checked
  pixel's channel, over the mean |reference|;
* ``preview_px_share``, ``sample_px_share``: the largest, over the
  checked actions, share of checked pixels whose value differs (some
  channel by more than ``ATOL + RTOL * |reference|``);
* ``pick_miss_share``: the share of checked picks whose block or face
  differs.

``low=True`` reads the control instead of the program: the reference in
bfloat16 (``reference/render.py``) in the program's place.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from vtbench import drive, traffic

# a checked pixel "differs" beyond this: float32 arithmetic in another
# order moves a value by a few ulps (1e-7 relative); bfloat16 by 4e-3
RTOL, ATOL = 1e-4, 1e-6


def read_exr(path) -> np.ndarray:
    """(H, W, 4) float32 of an uncompressed scanline OpenEXR file of
    32-bit float channels (the reference's Rgba32F frames)."""
    buf = Path(path).read_bytes()
    if struct.unpack_from("<I", buf, 0)[0] != 20000630:
        raise ValueError(f"{path}: not an OpenEXR file")
    pos, attrs = 8, {}
    while buf[pos] != 0:
        name_end = buf.index(b"\0", pos)
        type_end = buf.index(b"\0", name_end + 1)
        size = struct.unpack_from("<i", buf, type_end + 1)[0]
        attrs[buf[pos:name_end].decode()] = buf[type_end + 5:type_end + 5 + size]
        pos = type_end + 5 + size
    pos += 1
    if attrs["compression"] != b"\0":
        raise ValueError(f"{path}: compressed")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chans, raw = [], attrs["channels"]
    while raw and raw[0] != 0:
        end = raw.index(b"\0")
        chans.append(raw[:end].decode())
        if struct.unpack_from("<i", raw, end + 1)[0] != 2:
            raise ValueError(f"{path}: a channel is not 32-bit float")
        raw = raw[end + 17:]
    img = np.zeros((h, w, 4), np.float32)
    order = {"R": 0, "G": 1, "B": 2, "A": 3}
    for off in struct.unpack_from(f"<{h}Q", buf, pos):
        y = struct.unpack_from("<i", buf, off)[0]
        row = np.frombuffer(buf, np.float32, len(chans) * w, off + 8)
        for k, c in enumerate(chans):
            img[y - y0, :, order[c]] = row[k * w:(k + 1) * w]
    return img


def _differs(p, r):
    return (np.abs(p - r) > ATOL + RTOL * np.abs(r)).any(axis=-1)


class Reference:
    """The reference's side, built once after the window: the terrain from
    the configuration's noise seeds, its pack, and the LUT."""

    def __init__(self, cfg, device):
        import torch

        from vtbench.reference import render, terrain

        self.torch = torch
        self.render = render
        self.device = torch.device(device)
        w = cfg["world"]
        self.heights = terrain.heightmap(
            w["log2_size"], int(w["seed_scale"], 0), int(w["seed_noise"], 0),
            device=self.device)
        self.lut = render.lut(self.device)
        self._plain = None

    def world(self, states=None):
        from vtbench.reference.world import World

        if states is None:
            if self._plain is None:
                self._plain = World(self.heights, self.device)
            return self._plain
        return World(self.heights, self.device, states)

    def basis(self, yaw, pitch):
        from vtbench.reference import camera

        return camera.camera_basis(yaw, pitch)

    def pixels(self, px, py):
        t = self.torch
        return (t.from_numpy(np.asarray(px, np.int32)).to(self.device),
                t.from_numpy(np.asarray(py, np.int32)).to(self.device))


def sun_unit(sun) -> np.ndarray:
    """The float32 unit sun a Renderer traces under for ``sun`` (its
    ``_begin``)."""
    s = np.asarray(sun, np.float64)
    return (s / np.linalg.norm(s)).astype(np.float32)


def _accumulate(torch, rad, group, n, low):
    """The accumulator's mean of the (S, P, 3) samples ``rad`` as the
    program documents its sum: sample by sample into the buffer, or, where
    one add takes ``group`` samples (a mesh's step, in mesh order, or a
    headless batch), those summed in order first; then the buffer over the
    count ``n`` in float32 (``Accumulator.mean``). The control accumulates
    in bfloat16."""
    rad = rad.cpu()
    if low:
        rad = rad.to(torch.bfloat16)
    buf = torch.zeros_like(rad[0])
    for k in range(0, rad.shape[0], group):
        total = rad[k]
        for j in range(k + 1, min(k + group, rad.shape[0])):
            total = total + rad[j]
        buf = buf + total
    return buf.float().numpy() / n


def check_headless(ref: Reference, win: dict, cfg: dict, mix: dict,
                   seed: int, group: int, low: bool = False):
    """The numbers of a headless window (module doc) and the work counts
    of the reference's paths. ``group``: the samples of one accumulator
    add (``_accumulate``). ``low``: the control's numbers."""
    frames = win["frames"]
    if not frames:
        return dict(frames=0), {}
    f = int(traffic.rng(seed, 6).integers(len(frames)))
    fr = frames[f]
    W, H = win["pixels"]
    px, py = traffic.check_pixels(seed, mix["check"]["pixels"], W, H, 7)
    tpx, tpy = ref.pixels(px, py)
    pose, film = cfg["pose"], cfg["film"]
    # the frame's sun as headless_run normalises it, then as _begin does
    sun = np.asarray(fr["sun"], np.float64)
    sun = sun_unit(sun / np.linalg.norm(sun))
    job = dict(pos=pose["pos"], basis=ref.basis(pose["yaw"], pose["pitch"]),
               seeds=drive.frame_seeds(seed, fr["first_draw"], fr["samples"]))
    counts = {}

    def mean(lo):
        rad = ref.render.samples(
            ref.world(), ref.lut, [job], tpx, tpy, W, H, sun,
            film["max_bounces"], film["fog_steps"], low=lo,
            counts=None if lo else counts)[0]
        return _accumulate(ref.torch, rad, group, fr["samples"], lo)

    r = mean(False)
    p = mean(True) if low else read_exr(fr["exr"])[py, px, :3]
    err = np.abs(p - r)
    nums = dict(frame_l1=float(err.sum() / max(np.abs(r).sum(), 1e-30)),
                frame_px_max=float(err.max() / max(np.abs(r).mean(), 1e-30)))
    counts.update(frame=f, pixels=len(px), samples=fr["samples"])
    return nums, counts


def k9_work(ref: Reference, win: dict, cfg: dict, seed: int) -> dict:
    """The work of one K9 call of a headless window at batch 1 (a sample
    at every pixel: the checked frame's first), as the reference's paths
    define it: the paths, the bounces they begin alive, their fog
    marches, and ``pack_bytes``: the bytes of the heightfield pack's
    32-byte sectors that the paths' casts after the primaries read (the
    primaries' casts are K4's). For the yardstick (``yardstick/k9.py``);
    not part of the check."""
    from vtbench.reference import terrain

    frames = win["frames"]
    if not frames:
        return {}
    fr = frames[int(traffic.rng(seed, 6).integers(len(frames)))]
    W, H = win["pixels"]
    py, px = np.divmod(np.arange(W * H), W)
    tpx, tpy = ref.pixels(px, py)
    pose, film = cfg["pose"], cfg["film"]
    sun = np.asarray(fr["sun"], np.float64)
    sun = sun_unit(sun / np.linalg.norm(sun))
    job = dict(pos=pose["pos"], basis=ref.basis(pose["yaw"], pose["pitch"]),
               seeds=drive.frame_seeds(seed, fr["first_draw"], 1))
    world = ref.world()
    counts = {}
    touched = terrain.pack_sectors(world.tiles)
    ref.render.samples(world, ref.lut, [job], tpx, tpy, W, H, sun,
                       film["max_bounces"], film["fog_steps"],
                       counts=counts, touched=touched)
    counts["pack_bytes"] = int(touched.sum()) * 4 * terrain.SECTOR_FLOATS
    return counts


def check_session(ref: Reference, win: dict, cfg: dict, mix: dict,
                  seed: int, check_px: dict, shard: int, low: bool = False):
    """The numbers of a session window (module doc)."""
    recs = win["records"]
    allr = win["all_records"]
    first = len(allr) - len(recs)
    c = mix["check"]
    chosen = [first + i for i in traffic.pick_checked(seed, len(recs),
                                                      c["actions"])]
    if not chosen:
        return dict(actions=0), {}
    film = cfg["film"]
    W, H = film["width"], film["height"]
    sun = sun_unit(cfg["sun"])
    edits = [r["edited"] for r in allr]
    states = None
    if any(e is not None for e in edits):
        states = []
        for k in chosen:
            before = [e for e in edits[:k] if e is not None]
            states.append(before)
            states.append(before + ([edits[k]] if edits[k] else []))
    world = ref.world(states)
    ppx, ppy = ref.pixels(*check_px["preview"])
    spx, spy = ref.pixels(*check_px["sample"])
    spa = int(mix.get("samples_per_action", 1))
    jobs = []
    for j, k in enumerate(chosen):
        rec = allr[k]
        jobs.append(dict(
            pos=rec["pos"], yaw=rec["yaw"], pitch=rec["pitch"],
            basis=ref.basis(rec["yaw"], rec["pitch"]),
            seeds=drive.frame_seeds(seed, rec["first_draw"], spa * shard),
            state=None if states is None else 2 * j + 1,
            before=None if states is None else 2 * j))
    rp = ref.render.preview(world, jobs, ppx, ppy, W, H, sun).cpu().numpy()
    pp = ref.render.preview(world, jobs, ppx, ppy, W, H, sun,
                            low=True).cpu().numpy() if low else \
        np.stack([allr[k]["preview"] for k in chosen])
    prev_share = [float(_differs(pp[j], rp[j]).mean())
                  for j in range(len(chosen))]

    def accs(lo):
        rads = ref.render.samples(world, ref.lut, jobs, spx, spy, W, H, sun,
                                  film["max_bounces"], film["fog_steps"],
                                  low=lo)
        return [_accumulate(ref.torch, r, shard, r.shape[0], lo)
                for r in rads]

    rs = accs(False)
    ps = accs(True) if low else [
        allr[k]["acc"] / max(allr[k]["samples"], 1) if
        allr[k]["samples"] == spa * shard else None for k in chosen]
    samp_share = [1.0 if p is None else float(_differs(p, r).mean())
                  for p, r in zip(ps, rs)]
    nums = dict(preview_px_share=max(prev_share),
                sample_px_share=max(samp_share))
    picked = [(j, k) for j, k in enumerate(chosen) if allr[k]["kind"]]
    if picked:
        pj = [dict(jobs[j], state=jobs[j]["before"]) for j, _ in picked]
        want = ref.render.pick(world, pj)
        got = ref.render.pick(world, pj, low=True) if low else \
            [allr[k]["pick"] for _, k in picked]
        nums["pick_miss_share"] = sum(
            g != w for g, w in zip(got, want)) / len(picked)
    return nums, dict(actions=len(chosen), picks=len(picked))


def judge(nums: dict, limits: dict):
    """(correct, lines): every number beside its limit; a number missing
    or above its limit is not correct."""
    ok = True
    lines = []
    for name, lim in limits.items():
        v = nums.get(name)
        good = v is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        lines.append((name, v, lim))
    return ok, lines
