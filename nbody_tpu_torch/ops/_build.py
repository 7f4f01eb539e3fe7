"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` file has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds rather than minutes).  Libraries go to
``build/nbody_tpu_torch/<source-hash>/`` beside the package, keyed by the
source bytes and the flags, and are built at first use, never at import.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "nbody_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: "dict[str, ctypes.CDLL]" = {}
# Seconds each library took to build in this process (0.0 when an existing
# build was reused) and nvcc's report (ptxas registers / spills).
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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{name}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    t0 = time.perf_counter()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
            tmp_so = pathlib.Path(tmp) / so.name
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_so),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            BUILD_LOG[name] = proc.stdout + proc.stderr
            os.replace(tmp_so, so)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


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


def stream_handle(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(what: str, err: int) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
