"""ctypes binding to the native PNG encoder (native/nbody_native.cpp) with
transparent fallback to the pure-Python encoder.

A copy of ``nbody_tpu/viz/native_png.py`` (numpy only): the port runs
where JAX is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .png import encode_png as _py_encode_png


def _load():
    from ..oracle import native as oracle_native
    lib = oracle_native._load()
    if lib is None:
        return None
    if not hasattr(lib.png_encode_rgb, "_configured"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_encode_rgb.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, u8p, ctypes.c_int64]
        lib.png_encode_rgb.restype = ctypes.c_int64
        lib.png_max_size.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.png_max_size.restype = ctypes.c_int64
        lib.png_encode_rgb._configured = True
    return lib


def encode_png(rgb: np.ndarray, compress_level: int = 6) -> bytes:
    """Native PNG encode; falls back to the Python encoder if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return _py_encode_png(rgb, compress_level)
    rgb = np.ascontiguousarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"expected (H,W,3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    cap = lib.png_max_size(w, h)
    out = np.empty((cap,), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.png_encode_rgb(rgb.ctypes.data_as(u8p), w, h, compress_level,
                           out.ctypes.data_as(u8p), cap)
    if n < 0:
        return _py_encode_png(rgb, compress_level)
    return out[:n].tobytes()


def write_png(path: str, rgb: np.ndarray, compress_level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb, compress_level))
