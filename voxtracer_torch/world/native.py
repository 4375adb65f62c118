"""ctypes bindings for the native (C++) SVO builder and editor.

The port's own loader over the repository's ``native/svo_native.cpp``
(the counterpart of ``voxtracer/world/native.py``): the same hash-consed
octree semantics as the Python ``SvoSpace`` (interning, refcounts,
path-copy edits, collapsed terrain build) at C++ speed, which is what
makes the reference's 8192^3 world buildable in seconds. The library is
compiled with ``g++`` at first use into ``voxtracer_torch/_build/``,
named by a hash of the source, written under a temporary name and
renamed into place. There is no silent fallback: without a compiler
``load_library`` raises, and ``available()`` says so beforehand.

``NativeSvoSpace`` mirrors the ``SvoSpace`` surface the rest of the port
uses (get/set/leaf_at/height/capacity/num_nodes/serialize/
serialize_delta/mem_usage, the edit counters) plus the bulk
``build_terrain`` and the native box extractor ``extract_boxes_raw``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from voxtracer_torch.world.svo import EMPTY, DeviceSvo

SRC = Path(__file__).resolve().parents[2] / "native" / "svo_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None

_U32 = ctypes.c_uint32
_P = ctypes.c_void_p
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "vx_new": ((), _P),
    "vx_free": ((_P,), None),
    "vx_capacity": ((_P,), _U32),
    "vx_num_nodes": ((_P,), _U32),
    "vx_root": ((_P,), _U32),
    "vx_height": ((_P,), _U32),
    "vx_mem_usage": ((_P,), ctypes.c_uint64),
    "vx_build_terrain": ((_P, ctypes.POINTER(_U32), ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_float),
                         _U32),
    "vx_get": ((_P, _U32, _U32, _U32, ctypes.POINTER(ctypes.c_float)),
               ctypes.c_int),
    "vx_leaf_at": ((_P, _U32, _U32, _U32), ctypes.c_longlong),
    "vx_set": ((_P, _U32, _U32, _U32, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_float), None),
    "vx_serialize": ((_P, ctypes.POINTER(_U32)), _U32),
    "vx_solid_leaf": ((_P, ctypes.POINTER(ctypes.c_int32)), None),
    "vx_synced": ((_P,), ctypes.c_int),
    "vx_delta_size": ((_P,), _U32),
    "vx_delta_drain": ((_P, ctypes.POINTER(_U32), ctypes.POINTER(_U32),
                        ctypes.POINTER(ctypes.c_int32)), None),
    "vx_extract_boxes": ((_P, ctypes.c_int, ctypes.c_int, ctypes.c_int), _P),
    "vx_boxes_count": ((_P,), _U32),
    "vx_boxes_fill": ((_P, ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int32)), None),
    "vx_boxes_free": ((_P,), None),
}


def _ptr(a: np.ndarray, ctype=_U32):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    """Whether the native library is loaded or can be built here."""
    return _lib is not None or (shutil.which("g++") is not None
                                and SRC.exists())


def build() -> Path:
    """Compile the library unless one for this exact source exists."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"libvoxsvo_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native SVO builder is compiled "
                           "from native/svo_native.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded native library (built on first call); raises without a
    compiler."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _lib = lib
    return _lib


class NativeSvoSpace:
    """C++-backed SvoSpace with the same public surface."""

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.vx_new()
        self.edited = False  # any point edit since construction
        self.edit_count = 0  # set() calls (the library reports no no-ops)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vx_free(self._h)
            self._h = None

    def build_terrain(self, heights: np.ndarray, rgb=(0.5, 0.5, 0.5)):
        """heights: uint32[size, size] indexed [x, z], size = 2^k."""
        heights = np.ascontiguousarray(heights, np.uint32)
        size = heights.shape[0]
        log2 = int(size).bit_length() - 1
        if 1 << log2 != size or heights.shape != (size, size):
            raise ValueError(f"build_terrain: heights {heights.shape} is not "
                             "a square power of two")
        self._lib.vx_build_terrain(
            self._h, heights.ctypes.data_as(ctypes.POINTER(_U32)), log2,
            *[ctypes.c_float(c) for c in rgb])

    @property
    def root(self):
        r = self._lib.vx_root(self._h)
        return None if r == EMPTY else int(r)

    def height(self) -> int:
        return int(self._lib.vx_height(self._h))

    def capacity(self) -> int:
        return int(self._lib.vx_capacity(self._h))

    def num_nodes(self) -> int:
        return int(self._lib.vx_num_nodes(self._h))

    def mem_usage(self) -> int:
        return int(self._lib.vx_mem_usage(self._h))

    def get(self, p):
        rgb = (ctypes.c_float * 3)()
        ok = self._lib.vx_get(self._h, int(p[0]), int(p[1]), int(p[2]), rgb)
        return tuple(rgb) if ok else None

    def leaf_at(self, p):
        """Slot of the block leaf at p (its row in the device table), or
        None for air."""
        v = self._lib.vx_leaf_at(self._h, int(p[0]), int(p[1]), int(p[2]))
        return None if v < 0 else int(v)

    def set(self, p, rgb):
        """Point edit: place a block (rgb) or clear (None). Every call
        counts as an edit: it sets ``edited``, bumps ``edit_count`` and
        clears ``heights_exact``."""
        x, y, z = int(p[0]), int(p[1]), int(p[2])
        n = 1 << self.height()
        if not (0 <= x < n and 0 <= y < n and 0 <= z < n):
            raise ValueError(f"voxel {(x, y, z)} outside [0, {n})^3")
        self.edited = True
        self.heights_exact = False
        self.edit_count += 1
        if rgb is None:
            self._lib.vx_set(self._h, x, y, z, 0, 0.0, 0.0, 0.0)
        else:
            self._lib.vx_set(self._h, x, y, z, 1, float(rgb[0]),
                             float(rgb[1]), float(rgb[2]))

    def serialize(self) -> DeviceSvo:
        cap = max(self.capacity(), 1)
        table = np.full((cap, 8), EMPTY, np.uint32)
        root = self._lib.vx_serialize(self._h, _ptr(table))
        solid = np.full((cap,), -1, np.int32)
        self._lib.vx_solid_leaf(self._h, _ptr(solid, ctypes.c_int32))
        return DeviceSvo(table=table, root=int(root), height=self.height(),
                         solid_leaf=solid, space=self)

    def serialize_delta(self):
        """The rows changed since the last ``serialize`` or
        ``serialize_delta``, or None before a first ``serialize``
        (``SvoSpace.serialize_delta``'s contract)."""
        if not self._lib.vx_synced(self._h):
            return None
        k = int(self._lib.vx_delta_size(self._h))
        rows = np.empty(k, np.uint32)
        vals = np.empty((k, 8), np.uint32)
        solid = np.empty(k, np.int32)
        self._lib.vx_delta_drain(self._h, _ptr(rows), _ptr(vals),
                                 _ptr(solid, ctypes.c_int32))
        return (rows.astype(np.int64), vals, solid,
                int(self._lib.vx_root(self._h)), self.height(),
                self.capacity())

    def extract_boxes_raw(self, cull_enclosed=True, max_size=8,
                          max_strip=16):
        """The box soup of the octree by the native extractor (the
        pipeline of ``boxes.extract_boxes``): ``(lo int32[M, 3], size
        int32[M, 3], leaf int32[M])``."""
        r = self._lib.vx_extract_boxes(self._h, int(bool(cull_enclosed)),
                                       int(max_size), int(max_strip))
        try:
            m = int(self._lib.vx_boxes_count(r))
            lo = np.empty((m, 3), np.int32)
            size = np.empty((m, 3), np.int32)
            leaf = np.empty(m, np.int32)
            if m:
                i32 = ctypes.c_int32
                self._lib.vx_boxes_fill(r, _ptr(lo, i32), _ptr(size, i32),
                                        _ptr(leaf, i32))
        finally:
            self._lib.vx_boxes_free(r)
        return lo, size, leaf
