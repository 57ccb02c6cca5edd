"""Print the JAX package's RAFT-small golden aggregates under the bf16
mixed-precision policy, on the CPU: the anchor of chip_smoke.py's
``SMALL_MIXED_CPU`` (the port's RAFT-small under the policy on the card is
held within ``MIXED_BAND`` of it), which cannot import JAX on the card.

    JAX_PLATFORMS=cpu python scripts/golden_small_mixed_reference.py

It loads ``assets/golden/weights_small.npz`` at ``small=True,
mixed_precision=True``, iters=12, on the all-pairs engine (the pyramid
stored in bfloat16, as ``golden_cpu_reference.py`` runs RAFT-large's
policy), and prints one JSON line: the GT and parity EPE over the three
golden pairs.
"""

from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from raft_tpu.evaluate import (ASSETS_DIR, load_predictor,
                                   validate_golden_small)

    pred = load_predictor(os.path.join(ASSETS_DIR, "golden",
                                       "weights_small.npz"),
                          small=True, mixed_precision=True, iters=12,
                          corr_impl="fixed")
    res = validate_golden_small(pred)
    print(json.dumps({"small_mixed_gt_epe_cpu": res["golden_small_gt_epe"],
                      "small_mixed_parity_epe_cpu":
                          res["golden_small_parity_epe"]}))


if __name__ == "__main__":
    main()
