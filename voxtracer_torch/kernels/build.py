"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared
library with a plain C interface, bound with ctypes.

The library is compiled by ``nvcc`` at first use into
``voxtracer_torch/_build/``, named by a hash of the flags and of every
file under ``csrc/`` (headers included), written under a temporary name
and renamed into place, so concurrent builders never load a half-written
file. Each source compiles in its own ``nvcc`` process, all started
together, and one more links them; ptxas's per-kernel report (registers,
stack frame, spills) is kept beside the library as ``<name>.ptxas.txt``.
There is no prebuilt fallback: without ``nvcc`` the first launch on a
CUDA tensor raises.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` for Hopper, ``-O3``, and
``--fmad=false``: nvcc contracts ``a*b+c`` into one fused multiply-add by
default, which rounds differently from the plain PyTorch version (each op
rounded on its own) and flips edge-graze tie-breaks in the traversal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fog_march.cu", "svo_cast.cu", "resolve_fold.cu", "hf_cast.cu",
           "sky_tmin.cu", "beam_walk.cu", "beam_resolve.cu", "bit_dda.cu",
           "path_trace.cu", "sky_env.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes; each returns cudaGetLastError()
SIGNATURES = {
    # start, dir, density, y0, active, code, t, n, n_steps, planet_r,
    # planet_r2, fog_r2, fog_factor, counter, static_pct, chunk, refill,
    # work (or null), stream
    "voxt_fog_march": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F,
                       _P, _I, _I, _I, _P, _P),
    # table, root, height, start, dir, distance, active, skip_t0,
    # hit, t, node, normal, voxel, n, counter, static_pct, chunk, refill,
    # stream
    "voxt_svo_cast": (_P, _I, _I, _P, _P, _P, _P, _I,
                      _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P),
    # t_in, pl_in, rgb_in, rows, valid, tile_stride, dir, cam_x, cam_y,
    # cam_z, bound, distance, t_out, pl_out, rgb_out, n_tiles, rays, k,
    # ray_tile, spans, stream
    "voxt_resolve_fold": (_P, _P, _P, _P, _P, _L, _P, _F, _F, _F, _F, _F,
                          _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # t, pl, rgb, rows, n_records, tiles, start, n_slots, k, db, quantum,
    # dir, ok, tile_max, next_dmin, cam_x, cam_y, cam_z, bound, distance,
    # rays, ray_tile, spans, stream
    "voxt_resolve_fold_seg": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _P,
                              _P, _P, _P, _F, _F, _F, _F, _F, _I, _I, _I,
                              _P),
    # tiles, tile_log, levels, row_starts, height, hmax_w, start, dir,
    # distance, active, t_min, skip_t0, init_desc, hit, t, normal, voxel, n,
    # counter, static_pct, chunk, refill, stream
    "voxt_hf_cast": (_P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                     _P, _P, _P, _P, _I, _P, _I, _I, _I, _P),
    # E, S, bins, K, sw, dir, n, img_s, img_h, img_w, bin_w, log2_d0,
    # log2_g, far, t_min, stream
    "voxt_sky_tmin": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _F, _F, _F,
                      _F, _P, _P),
    # flat, row0, dp, tile_log, level_ints, level_floats, level_src,
    # n_levels, n_cells, cls_w, n_cls, consts, bins, K, sw, ws, ed, E, S,
    # stream
    "voxt_sky_env": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _I, _I,
                     _I, _P, _P, _P, _P, _P),
    # aug, height, olo, ohi, ilo, ihi, mirror, incoherent, K, max_steps,
    # skip_t0, h, ids_stk, mask_stk, entry_stk, words, cap, alive,
    # cand_lvl, cand_off, cand_rgb, ok, t_safe, n, stream
    "voxt_beam_walk": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # lvl, off, rgb, origin, origin_per_ray, dir, height, skip_t0, merge,
    # hit, t, normal, rgb_out, voxel, n_beams, P, K, stream
    "voxt_beam_resolve": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                          _P, _P, _I, _I, _I, _P),
    # top, top_words, regions, bricks, size, start, dir, distance, active,
    # skip_t0, hit, t, normal, voxel, n, counter, static_pct, chunk,
    # refill, stream
    "voxt_bit_dda": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                     _I, _P, _I, _I, _I, _P),
    # consts (host floats), n_consts, engine, tiles, tile_log, levels,
    # row_starts, hmax_w, table, root, height, boxes, n_boxes, bit_top,
    # top_words, bit_regions, bit_bricks, bit_size, t_near, t_far, near_n,
    # far_n, subres, pool, trgb, sun, pos, dir, light, density, state_in,
    # p_hit, p_t, p_normal, p_rgb, color, state_out, last, max_last, work,
    # n_work, ws, ws_words, counters, n_counters, n, max_bounces,
    # fog_steps, extra_draws, stats, static_pct, chunk, refill, stream
    "voxt_path_trace": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _I,
                        _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P),
}

# the persistent kernels index lanes (and 3 floats a lane) in int32
MAX_LANES = 1 << 28

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def compile_library(csrc: Path, out: Path, sources=SOURCES) -> str:
    """Compile ``sources`` of ``csrc`` into the shared library ``out``
    (one ``nvcc`` per source, all started together, then one link);
    returns ptxas's report. Raises with nvcc's errors on failure."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in sources]
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(csrc / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources, objs)]
    errors, report = [], []
    for s, p in zip(sources, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{s} ({p.returncode}):\n{err}")
        report.append(f"== {s}\n{err}")
    if not errors:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"link ({res.returncode}):\n{res.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if errors:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)
    return "".join(report)


def build() -> Path:
    """Compile the sources unless a library for this exact source hash
    exists; return its path."""
    out = BUILD_DIR / f"libvoxt_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = compile_library(CSRC, out)
    out.with_name(f"{out.name}.ptxas.txt").write_text(report)
    return out


def ptxas_report() -> str:
    """ptxas's report for the current library (after ``build``)."""
    path = BUILD_DIR / f"libvoxt_{_source_hash()}.so.ptxas.txt"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the sharded steps
    call it from one thread per card, so one thread builds)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
