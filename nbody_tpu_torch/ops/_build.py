"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` file has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds rather than minutes).  Libraries go to
``<root>/<source-hash>/`` under the build root (``utils/compcache.py``:
``build/nbody_tpu_torch/`` beside the package unless ``NBODY_COMPCACHE``
says otherwise), keyed by the source bytes, the shared headers
(``csrc/*.cuh``) and the flags, and are built at first use, never at
import; ``build_all`` starts one ``nvcc`` per missing library at once,
each writing into a temporary directory whose finished file is moved into
place in one step.

There is no fallback: a missing ``nvcc`` or a failed build raises.

Every call into a built library goes through one device guard:
``launch(what, t, entry, *args)`` for a kernel launch on ``t``'s card and
``query(device, entry, *args)`` for an occupancy or layout query.  Both
make the card current around the call, so that a kernel on shard i's
tensor is launched into card i's stream with card i current and a
cooperative grid is sized for the card it runs on; ``load`` hands out the
library's entries wrapped so that a call outside the guard raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from ..utils import compcache

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: "dict[str, Library]" = {}
# Seconds each library took to build in this process (wall time from the
# start of its batch; 0.0 when an existing build was reused) and nvcc's
# report (ptxas registers / spills).
BUILD_SECONDS: "dict[str, float]" = {}
BUILD_LOG: "dict[str, str]" = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "nbody_tpu_torch/csrc at first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return compcache.build_root() / h.hexdigest()[:16] / f"lib{name}.so"


def build_all(names) -> None:
    """Build every missing library of ``names`` with one ``nvcc`` each,
    all started together; raises if any build fails."""
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        so = library_path(name)
        if name in _LIBS or so.exists():
            continue
        tmp = compcache.staging(so)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp / so.name),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            compcache.publish(tmp, so)
        else:
            failed.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{out}")
            shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))


class _Guard(threading.local):
    # The device of the guarded call in progress on this thread, or
    # "host" for a query that reads no card; None outside the guard.
    device = None


_GUARD = _Guard()
# Kernel launches made through ``launch``, by card index.
DEVICE_LAUNCHES: "collections.Counter[int]" = collections.Counter()


class Entry:
    """A C entry of a built library that raises when it is called outside
    ``launch`` / ``query``; ``argtypes`` and ``restype`` pass through."""

    __slots__ = ("_name", "_fn")

    def __init__(self, name: str, fn):
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_fn", fn)

    def __getattr__(self, key):
        return getattr(self._fn, key)

    def __setattr__(self, key, value):
        setattr(self._fn, key, value)

    def __call__(self, *args):
        if _GUARD.device is None:
            raise RuntimeError(
                f"{self._name} was called outside the device guard; call "
                f"it through _build.launch or _build.query")
        return self._fn(*args)


class Library:
    """A loaded ``csrc/<name>.cu`` whose entries are ``Entry`` objects."""

    def __init__(self, cdll: ctypes.CDLL):
        self._cdll = cdll
        self._entries: "dict[str, Entry]" = {}

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = Entry(key, getattr(self._cdll, key))
        return entry


def load(name: str) -> Library:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all([name])
    else:
        BUILD_SECONDS.setdefault(name, 0.0)
    lib = Library(ctypes.CDLL(str(library_path(name))))
    _LIBS[name] = lib
    return lib


@contextlib.contextmanager
def _guarded(device):
    """One guarded call: ``device``'s card current, or no card at all for
    ``None`` (a layout constant of the library) and for a CPU tensor (the
    wrappers give built kernels none; only a test's stand-in library
    sees one)."""
    import torch
    if device is None:
        ctx, device = contextlib.nullcontext(), "host"
    else:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        ctx = (torch.cuda.device(device) if device.type == "cuda"
               else contextlib.nullcontext())
    prev = _GUARD.device
    with ctx:
        _GUARD.device = device
        try:
            yield
        finally:
            _GUARD.device = prev


def launch(what: str, t, entry, *args) -> None:
    """Launch through the C entry ``entry(*args, stream)`` on ``t``'s card:
    the card current, its current stream passed, the launch counted in
    ``DEVICE_LAUNCHES`` and its ``cudaGetLastError()`` checked."""
    with _guarded(t.device):
        err = entry(*args, stream_handle(t))
    DEVICE_LAUNCHES[t.device.index] += 1
    check_launch(what, err)


def query(device, entry, *args):
    """``entry(*args)`` with ``device``'s card current: an occupancy query
    (co-resident CTAs of a kernel on that card) or, with ``device=None``,
    a layout constant that reads no card."""
    with _guarded(device):
        return entry(*args)


def check_bodies(what: str, pos, mass) -> None:
    """The wrappers' input contract: float32, (N,3) positions beside (N,)
    masses, contiguous, on one device that is the CPU or CUDA."""
    import torch
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise ValueError(f"{what}: float32 only (got {pos.dtype}, "
                         f"{mass.dtype}); use impl='xla' for other dtypes")
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"{what}: pos must be (N, 3), got "
                         f"{tuple(pos.shape)}")
    if mass.shape != (pos.shape[0],):
        raise ValueError(f"{what}: mass must be ({pos.shape[0]},), got "
                         f"{tuple(mass.shape)}")
    if pos.device != mass.device:
        raise ValueError(f"{what}: pos on {pos.device}, mass on "
                         f"{mass.device}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {pos.device}")
    if not (pos.is_contiguous() and mass.is_contiguous()):
        raise ValueError(f"{what}: pos and mass must be contiguous")


def check_rect(what: str, pos_i, pos_j, mass_j,
               self_tile: bool = False) -> None:
    """The rect entry points' contract: ``check_bodies`` on the j-set, a
    contiguous float32 (Ni,3) i-set on the same device, and with
    ``self_tile`` an i-set no longer than the j-set (it must be a prefix,
    so that index equality means the same body)."""
    import torch
    check_bodies(what, pos_j, mass_j)
    if (pos_i.dtype != torch.float32 or pos_i.dim() != 2
            or pos_i.shape[1] != 3 or not pos_i.is_contiguous()
            or pos_i.device != pos_j.device):
        raise ValueError(f"{what}: pos_i must be a contiguous float32 "
                         f"(Ni, 3) tensor on {pos_j.device}")
    if self_tile and pos_j.shape[0] < pos_i.shape[0]:
        raise ValueError(
            "self_tile=True requires the j set to contain the i set as a "
            f"prefix (got Ni={pos_i.shape[0]} > Nj={pos_j.shape[0]}): index "
            "equality must mean 'same body'")


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(what: str, err: int) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
