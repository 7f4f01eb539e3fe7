"""ctypes binding to the native C++/OpenMP oracle (native/nbody_native.cpp).

The reference's validation oracle is native C++ with OpenMP
(``validation.cpp:28-52``); this is the rebuild's equivalent — structurally
independent from both the NumPy oracle and the device paths, so three
implementations cross-check each other.  Builds on demand with the system
toolchain (``make -C native``, g++ with OpenMP) if the shared library is
missing, and serial without ``-fopenmp`` where the toolchain has no OpenMP
runtime; falls back gracefully (callers should use ``available()``).

This file is a copy of ``nbody_tpu/oracle/native.py``: the port must run
where JAX is not installed, and importing anything under ``nbody_tpu``
imports JAX.  The library and its sources (``native/``) are shared by both
packages; ``tests/test_torch_native.py`` holds this copy against the numpy
oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libnbody_native.so"))

_lib: "Optional[ctypes.CDLL]" = None
_tried = False


# The Makefile's flags without -fopenmp: the source guards its OpenMP
# use, so a toolchain that has no OpenMP runtime builds a serial library.
_SERIAL_FLAGS = "CXXFLAGS=-O3 -march=native -fPIC -shared -Wall"


def _build() -> bool:
    for flags in ([], [_SERIAL_FLAGS]):
        try:
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR),
                            *flags], check=True, capture_output=True,
                           timeout=120)
            return os.path.exists(_LIB_PATH)
        except Exception:
            continue
    return False


def _load() -> "Optional[ctypes.CDLL]":
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.nbody_forces_f32.argtypes = [f32p, f32p, i64, ctypes.c_float, f32p]
    lib.nbody_forces_f64.argtypes = [f64p, f64p, i64, ctypes.c_double, f64p]
    lib.nbody_run_f32.argtypes = [f32p, f32p, f32p, f32p, i64,
                                  ctypes.c_float, ctypes.c_float, i64]
    lib.nbody_run_f64.argtypes = [f64p, f64p, f64p, f64p, i64,
                                  ctypes.c_double, ctypes.c_double, i64]
    if hasattr(lib, "nbody_run_kdk_f32"):   # older prebuilt .so lacks KDK
        lib.nbody_run_kdk_f32.argtypes = lib.nbody_run_f32.argtypes
        lib.nbody_run_kdk_f64.argtypes = lib.nbody_run_f64.argtypes
    lib.nbody_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.nbody_num_threads() if lib else 0


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_forces(pos: np.ndarray, mass: np.ndarray, eps2: float,
                  dtype=np.float64) -> np.ndarray:
    """All-pairs accelerations via the native oracle."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native oracle library unavailable "
                           f"(expected at {_LIB_PATH}; needs g++)")
    dtype = np.dtype(dtype)
    pos = np.ascontiguousarray(pos, dtype=dtype)
    mass = np.ascontiguousarray(mass, dtype=dtype)
    n = pos.shape[0]
    acc = np.empty((n, 3), dtype=dtype)
    if dtype == np.float32:
        lib.nbody_forces_f32(_ptr(pos, ctypes.c_float),
                             _ptr(mass, ctypes.c_float), n,
                             ctypes.c_float(eps2), _ptr(acc, ctypes.c_float))
    else:
        lib.nbody_forces_f64(_ptr(pos, ctypes.c_double),
                             _ptr(mass, ctypes.c_double), n,
                             ctypes.c_double(eps2), _ptr(acc, ctypes.c_double))
    return acc


def native_run(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
               eps2: float, dt: float, steps: int,
               dtype=np.float64, integrator: str = "reference"
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lock-step multi-step oracle run, entirely native.
    ``integrator``: "reference" (fused half-kick+drift, validation.cpp
    semantics) or "kdk" (leapfrog twin of ops/step.py's kdk path).
    Returns (pos, vel, acc)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native oracle library unavailable")
    if integrator not in ("reference", "kdk"):
        raise ValueError(f"unknown integrator {integrator!r}")
    if integrator == "kdk" and not hasattr(lib, "nbody_run_kdk_f64"):
        raise RuntimeError("native library predates KDK; rebuild with "
                           "make -C native")
    dtype = np.dtype(dtype)
    pos = np.ascontiguousarray(pos, dtype=dtype).copy()
    vel = np.ascontiguousarray(vel, dtype=dtype).copy()
    mass = np.ascontiguousarray(mass, dtype=dtype)
    acc = np.zeros_like(pos)
    n = pos.shape[0]
    if dtype == np.float32:
        fn = (lib.nbody_run_kdk_f32 if integrator == "kdk"
              else lib.nbody_run_f32)
        fn(_ptr(pos, ctypes.c_float), _ptr(vel, ctypes.c_float),
           _ptr(acc, ctypes.c_float), _ptr(mass, ctypes.c_float),
           n, ctypes.c_float(eps2), ctypes.c_float(dt), steps)
    else:
        fn = (lib.nbody_run_kdk_f64 if integrator == "kdk"
              else lib.nbody_run_f64)
        fn(_ptr(pos, ctypes.c_double),
           _ptr(vel, ctypes.c_double),
           _ptr(acc, ctypes.c_double),
           _ptr(mass, ctypes.c_double),
           n, ctypes.c_double(eps2), ctypes.c_double(dt), steps)
    return pos, vel, acc
