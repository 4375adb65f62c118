"""The benchmark's cells cut to a 2^6 world and a 32 x 16 film for the
CPU tests (``bench.main``'s test path; never the command line)."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
S = 64 / 8192  # the reference pose scaled to the 2^6 world


def overrides(cell: str, devices: int | None = None) -> dict:
    """The test path's overrides of ``cell``; ``devices``: the
    configuration's sample sharding, over that many CPU devices."""
    test = dict(
        config=dict(
            world={"log2_size": 6, "seed_scale": "0xafe29979",
                   "seed_noise": "0x1c766e2e"},
            film={"width": 32, "height": 16, "max_bounces": 3,
                  "fog_steps": 8},
            pose={"pos": [800.2352 * S, 1511.8693 * S, 654.40125 * S],
                  "yaw": -5.3800497, "pitch": 0.21999985},
            frame_samples=4),
        mix=dict(check={"pixels": 64, "actions": 8, "preview_pixels": 128,
                        "sample_pixels": 32, "center": 4},
                 trace={"skip": 1, "count": 3}))
    if cell.startswith("edit"):
        test["mix"]["pos"] = [800.2352 * S, 720.5 * S, 654.40125 * S]
    if cell.startswith("fly"):  # above the 2^6 terrain's 46 voxels
        test["mix"].update(move_step=1.0, radius=10.0,
                           pos=[800.2352 * S, 60.0, 654.40125 * S])
    if devices:
        test["config"]["devices"] = devices
    return test


def run(cell: str, seed: int = 3000000019, seconds: float = 2.0,
        trace: int = 0, devices: int | None = None):
    """One run of ``cell`` through the test path; (exit code, the last
    line's object or None)."""
    import contextlib
    import io
    import json

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from vtbench import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        time.monotonic(), test=overrides(cell, devices))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
