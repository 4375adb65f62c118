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
uses (get/set/leaf_at/height/capacity/num_nodes/serialize/mem_usage) plus
the bulk ``build_terrain``. The native box extractor and the serialize
delta belong to the edits slice and are not bound yet.
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
}


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
        """Point edit: place a block (rgb) or clear (None)."""
        x, y, z = int(p[0]), int(p[1]), int(p[2])
        n = 1 << self.height()
        if not (0 <= x < n and 0 <= y < n and 0 <= z < n):
            raise ValueError(f"voxel {(x, y, z)} outside [0, {n})^3")
        # a worldgen heightmap no longer describes the world
        self.heights_exact = False
        if rgb is None:
            self._lib.vx_set(self._h, x, y, z, 0, 0.0, 0.0, 0.0)
        else:
            self._lib.vx_set(self._h, x, y, z, 1, float(rgb[0]),
                             float(rgb[1]), float(rgb[2]))

    def serialize(self) -> DeviceSvo:
        cap = max(self.capacity(), 1)
        table = np.full((cap, 8), EMPTY, np.uint32)
        root = self._lib.vx_serialize(
            self._h, table.ctypes.data_as(ctypes.POINTER(_U32)))
        return DeviceSvo(table=table, root=int(root), height=self.height(),
                         space=self)
