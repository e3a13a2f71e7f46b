"""Per-stage wall-clock + throughput counters.

A copy of aquaculture_tpu/utils/timer.py: named stage timers accumulating
seconds and item counts, with a one-line report (the reference's only
visibility is tqdm bars). Host clock only: around device work, synchronize
before a stage ends, or the stage measures the enqueue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class StageTimer:
    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    @contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.items[name] = self.items.get(name, 0) + items

    def rate(self, name: str) -> float:
        s = self.seconds.get(name, 0.0)
        return self.items.get(name, 0) / s if s > 0 else 0.0

    def report(self) -> str:
        parts = []
        for name, s in sorted(self.seconds.items()):
            n = self.items.get(name, 0)
            parts.append(f"{name}: {s:.2f}s" + (f" ({n / s:.1f}/s)" if n and s > 0 else ""))
        return " | ".join(parts)
