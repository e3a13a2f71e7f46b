#!/usr/bin/env python3
"""The bf16 train step of two checkouts of the port, in turns on one card.

    python3 scripts/train_step_ab.py --other DIR [--rounds 2]

DIR is the root of another checkout (e.g. an earlier commit unpacked with
``git archive``). Each run is a process of its own that imports
``aquaculture_tpu_torch`` from one root and times its train step with this
checkout's harness, ``chip_smoke.time_train_step`` (m at 640, batch 16,
bf16, random weights from seed 0, one fixed batch on the card; plain and
--remat by CUDA events, and the plain step's profile: host enqueue, device
busy, kernels per step). The runs go other, this, this, other
(``--rounds`` times), so a drift of the card or the host over the call
weighs on both sides alike. One JSON line per run, then a summary line
with each side's mean and the ratio this / other; the card's name and
power limit are in every line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ms_per_step", "remat_ms_per_step", "host_enqueue_ms_per_step", "device_busy_ms_per_step",
        "kernels_per_step")


def child(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    card = harness.card_line()
    batch = harness._train_batch(np.random.default_rng(1), harness.TRAIN_BATCH, harness.TRAIN_IMG)
    rows = harness.time_train_step(torch.device("cuda", 0), card, batch)
    prof = rows["plain"]["profile"]
    import aquaculture_tpu_torch

    print(json.dumps({"root": root, "package": os.path.dirname(aquaculture_tpu_torch.__file__),
                      "ms_per_step": rows["plain"]["ms_per_step"], "remat_ms_per_step": rows["remat"]["ms_per_step"],
                      **{k: prof[k] for k in KEYS[2:]}, "card": card}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if not args.other:
        ap.error("--other is required")
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    got = {name: [] for name in sides}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", sides[name]],
                                  capture_output=True, text=True, cwd=sides[name], check=True)
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            if row["package"] != os.path.join(sides[name], "aquaculture_tpu_torch"):
                raise SystemExit(f"train_step_ab: {name} imported {row['package']}")
            got[name].append(row)
            print(json.dumps({"side": name, **row}), flush=True)
    mean = {name: {k: statistics.mean(r[k] for r in rows) for k in KEYS} for name, rows in got.items()}
    print(json.dumps({"summary": mean, "this_over_other": {k: mean["this"][k] / mean["other"][k] for k in KEYS},
                      "card": row["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
