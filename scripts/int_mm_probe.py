#!/usr/bin/env python3
"""Which int8 products ``torch._int_mm`` runs on this card, and exactly.

    python3 scripts/int_mm_probe.py

Tries every (M, K, N) of a small grid (row-major int8 operands, as
ops/int8_conv.py passes them: M rows of the im2col or of the NHWC storage,
K the contraction, N the output channels), compares each result with an
int64 product on the host, and prints one JSON line: the products that
were refused (cuBLASLt's CUBLAS_STATUS_NOT_SUPPORTED) or wrong, the count
tried, and the card's name and power limit. It explains ops/int8_conv.py's
ROW_MULTIPLE.
"""

from __future__ import annotations

import json
import subprocess
import sys

ROWS = (17, 24, 32, 40, 48, 50, 64, 96, 100, 128, 200, 208, 216, 224, 256, 400, 800, 1600)
DEPTHS = (64, 112, 1152)
COLS = (24, 64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int_mm_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for m in ROWS:
        for k in DEPTHS:
            for n in COLS:
                a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
                b = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
                try:
                    r = torch._int_mm(a, b)
                    torch.cuda.synchronize()
                except RuntimeError:
                    result[f"{m},{k},{n}"] = "refused"
                    continue
                exact = torch.equal(r.cpu().long(), a.cpu().long() @ b.cpu().long())
                result[f"{m},{k},{n}"] = "ok" if exact else "wrong"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"int_mm_not_ok": {k: v for k, v in result.items() if v != "ok"}, "tried": len(result),
                      "torch": torch.__version__, "cuda": torch.version.cuda, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
