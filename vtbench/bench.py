"""The benchmark's run: one cell (``BENCHMARK.json``'s ``workloads``),
one seed, one window, then the check; the last line of standard output is
the result's JSON object.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name in
``BENCHMARK.json``: ``configs/<name>.json`` (the entry's ``file``),
``workloads/<traffic>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voxtracer")  # top-level names, whole


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_benchmark(root: Path | None = None) -> dict:
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str):
    """(cell, configuration, traffic mix) of the cell ``name``."""
    from vtbench import traffic

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    return cell, cfg, traffic.load(cell["traffic"])


def metric_reader(name: str):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``
    with a ``read(run)`` that returns a number or None."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "vtbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, section: str):
    """The metrics of ``section`` that the cell reports: those with no
    ``workloads`` key, and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p95(values):
    """The 95th percentile (statistics' exclusive method), a failed
    request counting as missing any limit (inf)."""
    if len(values) < 2:
        return float(values[0]) if values else float("inf")
    return float(statistics.quantiles(values, n=20)[-1])


class Run:
    """What the metric readers read: the cell, the window's record, the
    profiled slice (``events``), and the check's counts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def end_to_end(win: dict) -> dict:
    """The cell's end-to-end numbers from its window (host clock)."""
    out = {}
    if win["kind"] == "headless":
        out["paths_px_s"] = win["samples"] / win["seconds"]
        log(f"window: {len(win['frames'])} frames, {win['samples']} samples "
            f"in {win['seconds']:.3f} s")
        return out
    recs = win["records"]
    fails = [float("inf")] * win["failed"]
    prev = [1e3 * r["preview_s"] for r in recs] + fails
    samp = [1e3 * s for r in recs for s in r["sample_s"]] + fails
    kind = "edit" if any(r["kind"] for r in recs) else "move"
    out[f"{kind}_preview_ms_p95"] = p95(prev)
    out["sample_ms_p95"] = p95(samp)
    for name, v in ((f"{kind}_preview_ms", prev), ("sample_ms", samp)):
        fin = [x for x in v if np.isfinite(x)]
        log(f"{name}: n {len(v)}, p50 {statistics.median(fin) if fin else 0:.4f}, "
            f"p95 {p95(v):.4f}, max {max(fin) if fin else 0:.4f}")
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="vtbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, test: dict | None = None) -> int:
    """One run. ``test``: the CPU tests' path only (never the command
    line): skip the look for a card, run on the CPU with the
    configuration's sizes overridden by ``test["config"]`` and the traffic
    mix's by ``test["mix"]``."""
    args = parse(argv)
    bench = load_benchmark()
    cell, cfg, mix = find_cell(bench, args.workload)
    chips = int(cell["chips"])
    from vtbench import drive

    drive.set_caches(ROOT)
    import torch

    if test is None:
        if not torch.cuda.is_available():
            log("no CUDA card: torch.cuda.is_available() is false")
            return 2
        if torch.cuda.device_count() < chips:
            log(f"the cell needs {chips} cards, the machine has "
                f"{torch.cuda.device_count()}")
            return 2
        device = "cuda"
    else:
        device = "cpu"
        cfg = {**cfg, **test.get("config", {})}
        mix = {**mix, **test.get("mix", {})}
    from vtbench import check, trace

    log(f"cell {cell['name']} seed {args.seed} seconds {args.seconds} "
        f"trace {args.trace}")
    prog = drive.Program(cfg, mix, args.seed, device, t0, log)
    log("setup: " + ", ".join(f"{k} {v:.4f}" for k, v in prog.parts.items())
        + f"; setup_s {prog.setup_s:.4f}")
    tracer = None
    if args.trace:
        tr = mix.get("trace", {})
        tracer = trace.Tracer(int(tr.get("skip", 0)), int(tr.get("count", 10)),
                              device)
    win = prog.run_window(args.seconds, tracer)
    if device == "cuda":  # read after the window: no part of set-up
        log(f"card after the window: {nvidia_smi()}")
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    events = tracer.export() if tracer is not None else None
    check_px = getattr(prog, "check_px", None)
    group = prog.group  # samples an accumulator add takes
    setup_s = prog.setup_s
    prog.close()
    try:
        ref = check.Reference(cfg, device)
        t_c = time.monotonic()
        if mix["kind"] == "headless":
            nums, counts = check.check_headless(ref, win, cfg, mix,
                                                args.seed, group)
        else:
            nums, counts = check.check_session(ref, win, cfg, mix,
                                               args.seed, check_px, group)
        log(f"check: {counts} in {time.monotonic() - t_c:.2f} s")
        if args.trace and mix["kind"] == "headless":
            t_c = time.monotonic()
            counts["k9_call"] = check.k9_work(ref, win, cfg, args.seed)
            log(f"K9's work a call: {counts['k9_call']} "
                f"in {time.monotonic() - t_c:.2f} s")
    finally:
        prog.remove_frames()
    del prog, ref
    correct, lines = check.judge(nums, mix["limits"])
    correct = correct and win["failed"] == 0 and win["attempted"] > 0

    metrics = {}
    if not args.trace:
        e2e = end_to_end(win)
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    run = Run(cell=cell, cfg=cfg, mix=mix, win=win, events=events,
              chips=chips, counts=counts, device=device)
    if args.trace:
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if events is not None and events.window is not None:
        busy = [events.busy_us(c) for c in events.cards()]
        dev["busy_s"] = sum(busy) / max(chips, len(busy)) * 1e-6
        dev["window_s"] = events.window_us * 1e-6
        out["breakdown"] = events.breakdown()
    out["check"] = {n: {"value": v, "limit": lim} for n, v, lim in lines}
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules the benchmark must not load: {bad}")
        return 3
    for n, v, lim in lines:
        log(f"check {n}: {v} (limit {lim})")
    print(json.dumps(out), flush=True)
    return 0
