"""Blank / partly-blank image detection (numpy, host).

A copy of aquaculture_tpu/data/blank.py, the reference's WMS-download probe
(reference: src/utils.py:325-369): an image is blank when its grayscale
extrema collapse to all-black, all-near-white, or the constant 1; partly
blank when any full row or column averages >= 250. Operates on arrays
instead of PIL method calls.
"""

from __future__ import annotations

import numpy as np

_GRAY = np.asarray([0.299, 0.587, 0.114])  # PIL 'L' conversion weights


def _to_gray(im: np.ndarray) -> np.ndarray:
    if im.ndim == 2:
        return im.astype(np.float64)
    return im[..., :3].astype(np.float64) @ _GRAY


def is_blank(im: np.ndarray) -> bool:
    """True when the image is uniformly black / white / near-white
    (extrema rules of reference utils.py:338-348)."""
    g = np.floor(_to_gray(im))  # PIL L-mode quantizes; floor matches uint8
    lo, hi = float(g.min()), float(g.max())
    if (lo, hi) == (0.0, 0.0):
        return True
    if (lo, hi) == (1.0, 1.0):
        return True
    if (lo, hi) == (255.0, 255.0):
        return True
    if lo >= 250.0 and hi >= 250.0:
        return True
    return False


def is_partly_blank(im: np.ndarray) -> bool:
    """True when any full pixel row or column averages >= 250
    (reference utils.py:352-369)."""
    a = im.astype(np.float64)
    if a.ndim == 2:
        a = a[:, :, None]
    row_avg = a.mean(axis=(1, 2))
    col_avg = a.mean(axis=(0, 2))
    return bool((row_avg >= 250.0).any() or (col_avg >= 250.0).any())


def blank_fraction(im: np.ndarray, thresh: float = 250.0) -> float:
    """Fraction of near-white pixels (whitespace-aware dedup weighting)."""
    g = _to_gray(im)
    return float((g >= thresh).mean())
