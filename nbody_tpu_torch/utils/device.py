"""Device introspection and the no-silent-fallback rule.

``require_device`` refuses ``cuda`` when there is no card instead of
carrying on on the CPU.  ``device_info`` reports what the JAX package's
``print_device_info`` reports for a TPU, for the card: name, SM count,
memory, and the name / power limit line of ``nvidia-smi``.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def nvidia_smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card, or "not available"."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not available"
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else \
        "not available"


def device_info() -> "list[dict]":
    infos = []
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu"}]
    smi = nvidia_smi_line()
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        infos.append({
            "id": i, "platform": "gpu", "device_kind": p.name,
            "sm_count": p.multi_processor_count,
            "hbm_bytes": p.total_memory,
            "capability": f"{p.major}.{p.minor}",
            "nvidia_smi": smi,
        })
    return infos


def print_device_info() -> None:
    print("== Device Properties ==")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuda available: {torch.cuda.is_available()}")
    for info in device_info():
        parts = [f"[{info['id']}] {info['device_kind']} ({info['platform']})"]
        if "sm_count" in info:
            parts.append(f"{info['sm_count']} SMs")
            parts.append(f"HBM {info['hbm_bytes'] / 2**30:.1f} GiB")
            parts.append(f"sm_{info['capability'].replace('.', '')}")
            parts.append(f"nvidia-smi: {info['nvidia_smi']}")
        print("  " + "  ".join(parts))
