#!/usr/bin/env python3
"""How far K8's sums of the pair potential are from float64 once the self
terms are taken out, on the card.

    python3 tools/pe_self_bias.py

K8 is mask-free: a row's sum includes its self term ``m_i^2 rsqrt(eps2)``,
which the energy takes out again in float64.  Where the self terms
outweigh the pair sums (small N in the reference's box: ~390 times at N =
8192), what is left is the float32 partials' rounding of a sum that held
the self term.  For each body set this prints the self total over the
pair sums and, relative to the float64 pair sums (``chip_smoke.py``'s
``pe_total_f64`` less the closed-form self total), the pair sums of:

- ``pe_rows``: K8's row sums of every body, less ``m^2 rsqrt(float32
  eps2)`` (K8's own self term, as ``parallel/energy.py`` subtracts it);
- ``pe_total``: K8's symmetric total, less the same;
- the plain twin ``pe_rows_plain`` run on the card (a tile's float32 sum
  by ``torch.sum``, not a sequential chain), less the same;
- float32 row sums with the self pair masked (``torch.rsqrt``, rsqrtf's
  bits, and ``1 / torch.sqrt``, correctly rounded).

Needs a CUDA card and nvcc; about 20 s on one H100.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

CASES = ((5, 8192), (0, 8192), (5, 65536))
EPS2 = 0.002


def masked_rows(pos, mass, eps2, inv, rows=1024):
    """sum_i m_i sum_{j != i} m_j inv(|r|^2 + eps2), float32 rows, float64
    across them."""
    total, n = 0.0, pos.shape[0]
    for r0 in range(0, n, rows):
        d = pos[None, :, :] - pos[r0:r0 + rows, None, :]
        d2 = (d * d).sum(-1) + eps2
        idx = torch.arange(r0, min(r0 + rows, n), device=pos.device)
        d2[idx - r0, idx] = float("inf")
        total += float((mass[r0:r0 + rows].double()
                        * (mass[None, :] * inv(d2)).sum(1).double()).sum())
    return total


def main():
    if not torch.cuda.is_available():
        print("pe_self_bias: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import pe
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    print(nvidia_smi_line())
    r_self = float(torch.rsqrt(torch.tensor(EPS2, dtype=torch.float32,
                                            device="cuda")))
    for seed, n in CASES:
        s = nt.init_state(nt.SimConfig(n_bodies=n, seed=seed))
        pos, mass = s.pos, s.mass
        m2 = float((mass.double() ** 2).sum())
        exact = chip_smoke.pe_total_f64(pos, mass, EPS2) - m2 / EPS2 ** 0.5
        sums = {
            "pe_rows": float(pe.pe_rows(pos, mass, pos, mass, EPS2).sum())
            - m2 * r_self,
            "pe_total": float(pe.pe_total(pos, mass, EPS2)) - m2 * r_self,
            "twin": float(pe.pe_rows_plain(pos, mass, pos, mass, EPS2)
                          .sum()) - m2 * r_self,
            "masked rsqrt": masked_rows(pos, mass, EPS2, torch.rsqrt),
            "masked 1/sqrt": masked_rows(pos, mass, EPS2,
                                         lambda d2: 1.0 / torch.sqrt(d2))}
        print(f"seed {seed}, N = {n}: self total / pair sums "
              f"{m2 / EPS2 ** 0.5 / exact:.1f}; pair sums against float64: "
              + ", ".join(f"{k} {(v - exact) / exact:+.3e}"
                          for k, v in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
