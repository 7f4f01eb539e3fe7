#!/usr/bin/env python3
"""The operand-ingestion probe of ``scripts/r3_platbug.py`` on the port.

    python3 scripts/r3_platbug_torch.py [--device cuda|cpu]

Sums the columns of a bf16 pack ``[x_hi | x_lo | 1 | 0]`` of 16,384
positions (uniform in +-1e5, ``numpy.random.default_rng(3)``) in blocks of
2048 rows three ways: the pack built on the card by torch, the same bits
round-tripped through the host, and the pack derived in the kernel with
the tensor-core tiers' own split (``nbody_tpu_torch/ops/probes.py``,
``csrc/probes.cu``).  Prints each sum's largest relative error against the
float64 host sum, the largest difference between the first two, the
verdict and one JSON record; exits 1 unless the three agree bit for bit,
each equals its plain PyTorch version, and the verdict is clean.  Writes
no file.  ``--device cpu`` runs the plain versions.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nbody_tpu_torch.ops.probes import run_r3  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    rec = run_r3(ap.parse_args(argv).device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
