"""The readings that the check's limits are set from, for one cell: the
program's numbers on several seeds and the control's (the reference in
bfloat16 in the program's place, ``check.py``), at the cell's own size
and load, in one process:

    python3 vtbench/readings.py --workload <cell> --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 1

Each seed gets its own Renderer and a short window (``--seconds``: a
headless window still holds a whole frame); the world is built once and
shared, since it does not depend on the seed. Not part of a benchmark
run. One line of JSON a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv, test=None):
    ap = argparse.ArgumentParser(prog="vtbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from vtbench import bench, check, drive

    b = bench.load_benchmark()
    cell, cfg, mix = bench.find_cell(b, args.workload)
    drive.set_caches(bench.ROOT)
    import torch

    device = "cpu" if test else "cuda"
    if test:
        cfg = {**cfg, **test.get("config", {})}
        mix = {**mix, **test.get("mix", {})}
    elif not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        bench.log("the cell's cards are not there")
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    space = None
    out = []
    for seed in sorted(set(seeds) | ctrl):
        prog = drive.Program(cfg, mix, seed, device, time.monotonic(),
                             bench.log, space=space)
        space = prog.space
        win = prog.run_window(args.seconds)
        px, group = getattr(prog, "check_px", None), prog.group
        prog.renderer = None
        ref = check.Reference(cfg, device)
        row = dict(seed=seed, attempted=win["attempted"], failed=win["failed"])
        for low in ([False] if seed not in ctrl else [False, True]) \
                if seed in seeds else [True]:
            if mix["kind"] == "headless":
                nums, _ = check.check_headless(ref, win, cfg, mix, seed,
                                               group, low=low)
            else:
                nums, _ = check.check_session(ref, win, cfg, mix, seed, px,
                                              group, low=low)
            row["control" if low else "program"] = nums
        prog.remove_frames()
        del ref
        if device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        out.append(row)
    return 0 if out else 1


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
