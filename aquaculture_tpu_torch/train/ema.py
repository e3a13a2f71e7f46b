"""Exponential moving average of the model's state.

Counterpart of aquaculture_tpu/train/ema.py (public YOLOv5 ModelEMA): the
decay ramps in as d(step) = decay * (1 - exp(-step / tau)), tau = 2000, and
every float tensor of the state moves, BN running statistics included.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], current: Dict[str, torch.Tensor], step: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """ema = d * ema + (1 - d) * current, in place, for every name of
    ``ema``; d(step) in float32 in the JAX package's operation order."""
    f = np.float32
    d = f(f(decay) * (f(1.0) - np.exp(-f(step) / f(tau))))
    es = list(ema.values())
    torch._foreach_mul_(es, float(d))
    torch._foreach_add_(es, torch._foreach_mul([current[n].float() for n in ema], float(np.float32(1.0) - d)))
