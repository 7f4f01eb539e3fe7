#!/usr/bin/env python3
"""The manual-DMA probes of ``scripts/r8_mosaic_rules.py`` on the port.

    python3 scripts/r8_mosaic_rules_torch.py [--device cuda|cpu]

Runs each of the JAX script's probes on an (8, 128) float32 tile as a
kernel of the card (``nbody_tpu_torch/ops/probes.py``,
``csrc/probes.cu``): a copy through a device workspace (1a, 1b), staged
through shared memory (1c), a row slice (2a), a row split of the loaded
value (2b), an (8, 3) buffer padded to 128 lanes (3a), a narrow transpose
(3b), and the remote copy to itself at P = 1 as K13's peer store and flag
(4).  Prints each probe's label, OK or FAIL, and whether its output is
exact: equal to its plain PyTorch version, the array the JAX body defines;
beside it the v5e expectation the JAX script records; then one JSON
record.  Exits 1 unless every probe is OK and exact.
``--device cpu`` runs the plain versions.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nbody_tpu_torch.ops.probes import run_r8  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    rec = run_r8(ap.parse_args(argv).device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
