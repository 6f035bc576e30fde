"""ctypes bindings for the native host runtime (native/drts_native.cpp).

The C++ library provides the host-side heavy lifting the reference does in
native code (geosphere generation, tangent frames, Halton tables, PNG
encode — SURVEY.md §2.3 DirectXTK/DirectXMesh/MathLib rows).
Every entry point has a numpy fallback in the pure-Python modules; `lib()`
returns None when the .so hasn't been built (`make -C native`), and
callers transparently fall back.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libdrts_native.so")
_lib = None
_loaded = False


def lib():
    global _lib, _loaded
    if not _loaded:
        _loaded = True
        if os.path.exists(_LIB_PATH):
            try:
                _lib = ctypes.CDLL(_LIB_PATH)
                _configure(_lib)
            except OSError:
                _lib = None
    return _lib


def _configure(so):
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    so.geosphere_counts.argtypes = [ctypes.c_int, ctypes.c_float,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    so.geosphere_copy.argtypes = [f32p, f32p, f32p, i32p]
    so.tangent_frame.argtypes = [i32p, ctypes.c_int, f32p, f32p, f32p,
                                 ctypes.c_int, f32p]
    so.halton23.argtypes = [ctypes.c_int, ctypes.c_int, f32p]
    so.write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def create_geosphere(diameter: float = 1.0, tessellation: int = 3):
    """Native geosphere; None if the library is unavailable."""
    so = lib()
    if so is None:
        return None
    vc = ctypes.c_int()
    fc = ctypes.c_int()
    if so.geosphere_counts(tessellation, ctypes.c_float(diameter),
                           ctypes.byref(vc), ctypes.byref(fc)) != 0:
        return None
    pos = np.empty((vc.value, 3), np.float32)
    nrm = np.empty((vc.value, 3), np.float32)
    uv = np.empty((vc.value, 2), np.float32)
    idx = np.empty((fc.value, 3), np.int32)
    so.geosphere_copy(_fp(pos), _fp(nrm), _fp(uv), _ip(idx))
    return pos, nrm, uv, idx


def compute_tangent_frame(indices, positions, normals, uvs):
    so = lib()
    if so is None:
        return None
    idx = np.ascontiguousarray(indices, np.int32)
    pos = np.ascontiguousarray(positions, np.float32)
    nrm = np.ascontiguousarray(normals, np.float32)
    uv = np.ascontiguousarray(uvs, np.float32)
    out = np.empty_like(pos)
    so.tangent_frame(_ip(idx), idx.shape[0], _fp(pos), _fp(nrm), _fp(uv),
                     pos.shape[0], _fp(out))
    return out


def halton23(count: int, start: int = 0):
    so = lib()
    if so is None:
        return None
    out = np.empty((count, 2), np.float32)
    so.halton23(count, start, _fp(out))
    return out


def write_png(path: str, image: np.ndarray) -> bool:
    so = lib()
    if so is None:
        return False
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    rc = so.write_png(path.encode(),
                      img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      w, h, c)
    return rc == 0
