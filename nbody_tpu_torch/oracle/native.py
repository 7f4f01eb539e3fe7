"""ctypes binding to the native C++/OpenMP oracle (native/nbody_native.cpp).

The reference's validation oracle is native C++ with OpenMP
(``validation.cpp:28-52``); this is the rebuild's equivalent — structurally
independent from both the NumPy oracle and the device paths, so three
implementations cross-check each other.  The library is built at first
use with g++ and ``native/Makefile``'s flags, serial without
``-fopenmp`` where the toolchain has no OpenMP runtime; callers should
use ``available()``.

A copy of ``nbody_tpu/oracle/native.py`` (numpy only): the port must run
where JAX is not installed, and importing anything under ``nbody_tpu``
imports JAX.  It differs in where the library goes.  The JAX binding runs
``make -C native``, which writes ``native/libnbody_native.so`` in place,
so several processes building at once can see no library or half of one.
This one reads ``native/nbody_native.cpp`` (it writes nothing under
``native/``) and compiles it into the build root (``utils/compcache.py``)
under a directory keyed by the source and the flags, through a temporary
directory and ``os.replace``: a process sees no library or a whole one.
``tests/test_torch_native.py`` holds it against the numpy oracle and
against the JAX binding loaded from this build.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..utils import compcache

SOURCE = (pathlib.Path(__file__).resolve().parent.parent.parent / "native"
          / "nbody_native.cpp")
# native/Makefile's CXXFLAGS (less -fopenmp, added where the toolchain has
# OpenMP) and LDLIBS.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")
LDLIBS = ("-lz",)

_lib: "Optional[ctypes.CDLL]" = None
_tried = False


def _flags(openmp: bool) -> tuple:
    return CXXFLAGS + (("-fopenmp",) if openmp else ())


def library_path(openmp: bool = True) -> pathlib.Path:
    """Where the build of ``SOURCE`` with (or without) OpenMP goes."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*_flags(openmp), *LDLIBS)).encode())
    return (compcache.build_root() / h.hexdigest()[:16]
            / "libnbody_native.so")


def _compile(openmp: bool) -> bool:
    so = library_path(openmp)
    tmp = compcache.staging(so)
    try:
        subprocess.run(["g++", *_flags(openmp), "-o", str(tmp / so.name),
                        str(SOURCE), *LDLIBS], check=True,
                       capture_output=True, timeout=120)
        compcache.publish(tmp, so)
        return True
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        return False


def built_library() -> Optional[pathlib.Path]:
    """The library to load: an existing build (OpenMP first), else a new
    one (OpenMP, then serial); None where g++ builds neither."""
    for openmp in (True, False):
        if library_path(openmp).exists():
            return library_path(openmp)
    for openmp in (True, False):
        if _compile(openmp):
            return library_path(openmp)
    return None


def _load() -> "Optional[ctypes.CDLL]":
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = built_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
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
                           f"(built from {SOURCE}; needs g++)")
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
