"""Plain PyTorch all-pairs force paths, the counterparts of
``nbody_tpu/ops/forces_xla.py``: impls ``xla_nxn`` (``forces_nxn``) and
``xla`` (``forces_chunked``), the CPU / float64 / bfloat16 path, and
``rect_forces``, the port's independent cross-check of the kernels.

Force law: ``d2 = |r_ij|^2 + eps2; a_i += m_j r_ij rsqrt(d2^3)`` with no
i != j guard in the direct form (the self-pair vanishes by r = 0).
"""

from __future__ import annotations

import torch


def _pair_factor(d2: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(d2 * d2 * d2)


def rect_forces(pos_i: torch.Tensor, pos_j: torch.Tensor,
                mass_j: torch.Tensor, eps2: float,
                chunk: int = 1024) -> torch.Tensor:
    """Forces of body set j on body set i, direct form, chunked over i.
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3)."""
    out = []
    for s in range(0, pos_i.shape[0], chunk):
        r = pos_j[None, :, :] - pos_i[s:s + chunk, None, :]   # (C, Nj, 3)
        d2 = (r * r).sum(-1) + eps2
        f = mass_j[None, :] * _pair_factor(d2)
        out.append((f[:, :, None] * r).sum(1))
    return torch.cat(out) if out else torch.zeros_like(pos_i)


def forces_nxn(pos: torch.Tensor, mass: torch.Tensor,
               eps2: float) -> torch.Tensor:
    """Full NxN interaction tensor, reduced along j. (N,3),(N,) -> (N,3)."""
    r = pos[None, :, :] - pos[:, None, :]          # r_ij = x_j - x_i
    d2 = (r * r).sum(-1) + eps2
    f = mass[None, :] * _pair_factor(d2)
    return (f[:, :, None] * r).sum(1)


def forces_chunked(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                   chunk: int = 1024) -> torch.Tensor:
    """(C, N) interaction blocks accumulated as ``a_i = f @ pos -
    x_i * rowsum(f)``.  The self-pair is masked: through the matmul its
    factor m_i rsqrt(eps2^3) would cancel only in exact arithmetic.  The
    float32 product must stay full fp32 (TF32 keeps ~3 digits)."""
    if pos.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "forces_chunked needs full-fp32 matmuls: "
            "torch.backends.cuda.matmul.allow_tf32 is True")
    n = pos.shape[0]
    out = []
    for s in range(0, n, chunk):
        pos_c = pos[s:s + chunk]
        r = pos[None, :, :] - pos_c[:, None, :]    # (C, N, 3)
        d2 = (r * r).sum(-1) + eps2
        f = mass[None, :] * _pair_factor(d2)       # (C, N)
        rows = torch.arange(pos_c.shape[0], device=pos.device)
        f[rows, rows + s] = 0.0
        out.append(f @ pos - pos_c * f.sum(1, keepdim=True))
    return torch.cat(out)
