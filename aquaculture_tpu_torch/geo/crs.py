"""Closed-form coordinate reference system transforms (no PROJ dependency).

Implements the three CRSs used by the pipeline
(reference: src/utils.py:20, src/process_yolo/geocode_results.py:31):

* EPSG:4326  — WGS84 geographic lon/lat (degrees)
* EPSG:3857  — WGS84 / Pseudo ("Web") Mercator (meters); spherical formulas
* EPSG:3035  — ETRS89-extended / LAEA Europe (meters); ellipsoidal Lambert
               Azimuthal Equal-Area on GRS80, lat0=52N lon0=10E,
               FE=4321000, FN=3210000 (IOGP Guidance Note 7-2 formulas)

All functions are vectorized NumPy float64 (geodesy needs f64: float32 has
~0.5 m quantization at the ~5e6 m coordinate magnitudes involved). A copy
of aquaculture_tpu/geo/crs.py: the detector on the device never needs these;
geocoding is an O(n_detections) host epilogue.

Axis convention: every function takes/returns (x=easting, y=northing),
i.e. pyproj's ``always_xy=True`` semantics. NOTE the reference passes
EPSG:3035 results through pyproj's authority axis order (northing first,
geocode_results.py:177-178), silently swapping x/y in its ``*_m`` columns;
its downstream area formulas are symmetric in width/height so results are
unaffected. We use the consistent (easting, northing) order everywhere.
"""

from __future__ import annotations

import numpy as np

# --- WGS84 / GRS80 ellipsoid constants ---
WGS84_A = 6378137.0
GRS80_INV_F = 298.257222101
GRS80_F = 1.0 / GRS80_INV_F
GRS80_E2 = GRS80_F * (2.0 - GRS80_F)          # first eccentricity squared
GRS80_E = np.sqrt(GRS80_E2)

# --- EPSG:3035 projection parameters ---
LAEA_LAT0 = np.deg2rad(52.0)
LAEA_LON0 = np.deg2rad(10.0)
LAEA_FE = 4321000.0
LAEA_FN = 3210000.0

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi


def mercator_forward(lon, lat):
    """EPSG:4326 lon/lat (deg) -> EPSG:3857 x/y (m)."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    x = WGS84_A * lon * _D2R
    y = WGS84_A * np.log(np.tan(np.pi / 4.0 + lat * _D2R / 2.0))
    return x, y


def mercator_inverse(x, y):
    """EPSG:3857 x/y (m) -> EPSG:4326 lon/lat (deg)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lon = x / WGS84_A * _R2D
    lat = (2.0 * np.arctan(np.exp(y / WGS84_A)) - np.pi / 2.0) * _R2D
    return lon, lat


def _authalic_q(sin_phi: np.ndarray) -> np.ndarray:
    e = GRS80_E
    e2 = GRS80_E2
    return (1.0 - e2) * (
        sin_phi / (1.0 - e2 * sin_phi * sin_phi)
        - (1.0 / (2.0 * e)) * np.log((1.0 - e * sin_phi) / (1.0 + e * sin_phi))
    )


_QP = _authalic_q(np.float64(1.0))                       # q at the pole
_Q0 = _authalic_q(np.sin(LAEA_LAT0))
_BETA0 = np.arcsin(_Q0 / _QP)
_RQ = WGS84_A * np.sqrt(_QP / 2.0)
_M0 = np.cos(LAEA_LAT0) / np.sqrt(1.0 - GRS80_E2 * np.sin(LAEA_LAT0) ** 2)
_D = WGS84_A * _M0 / (_RQ * np.cos(_BETA0))


def laea_forward(lon, lat):
    """EPSG:4326 lon/lat (deg) -> EPSG:3035 easting/northing (m)."""
    lam = np.asarray(lon, dtype=np.float64) * _D2R
    phi = np.asarray(lat, dtype=np.float64) * _D2R

    q = _authalic_q(np.sin(phi))
    beta = np.arcsin(np.clip(q / _QP, -1.0, 1.0))
    dlam = lam - LAEA_LON0

    b = _RQ * np.sqrt(
        2.0
        / (1.0 + np.sin(_BETA0) * np.sin(beta) + np.cos(_BETA0) * np.cos(beta) * np.cos(dlam))
    )
    easting = LAEA_FE + b * _D * np.cos(beta) * np.sin(dlam)
    northing = LAEA_FN + (b / _D) * (
        np.cos(_BETA0) * np.sin(beta) - np.sin(_BETA0) * np.cos(beta) * np.cos(dlam)
    )
    return easting, northing


def laea_inverse(easting, northing):
    """EPSG:3035 easting/northing (m) -> EPSG:4326 lon/lat (deg)."""
    x = (np.asarray(easting, dtype=np.float64) - LAEA_FE) / _D
    y = (np.asarray(northing, dtype=np.float64) - LAEA_FN) * _D

    rho = np.hypot(x, y)
    # Guard rho=0 (projection center) to avoid 0/0.
    rho_safe = np.where(rho == 0.0, 1.0, rho)
    ce = 2.0 * np.arcsin(np.clip(rho / (2.0 * _RQ), -1.0, 1.0))

    sin_beta = np.cos(ce) * np.sin(_BETA0) + (y * np.sin(ce) * np.cos(_BETA0)) / rho_safe
    sin_beta = np.where(rho == 0.0, np.sin(_BETA0), np.clip(sin_beta, -1.0, 1.0))
    beta = np.arcsin(sin_beta)

    lam = LAEA_LON0 + np.arctan2(
        x * np.sin(ce),
        rho_safe * np.cos(_BETA0) * np.cos(ce) - y * np.sin(_BETA0) * np.sin(ce),
    )
    lam = np.where(rho == 0.0, LAEA_LON0, lam)

    # Authalic latitude -> geodetic latitude (Snyder 3-18 series).
    e2 = GRS80_E2
    e4 = e2 * e2
    e6 = e4 * e2
    phi = (
        beta
        + (e2 / 3.0 + 31.0 * e4 / 180.0 + 517.0 * e6 / 5040.0) * np.sin(2.0 * beta)
        + (23.0 * e4 / 360.0 + 251.0 * e6 / 3780.0) * np.sin(4.0 * beta)
        + (761.0 * e6 / 45360.0) * np.sin(6.0 * beta)
    )
    return lam * _R2D, phi * _R2D


_FWD = {
    (4326, 3857): mercator_forward,
    (3857, 4326): mercator_inverse,
    (4326, 3035): laea_forward,
    (3035, 4326): laea_inverse,
}


def transform(src: int, dst: int, x, y):
    """Transform (x, y) arrays from EPSG:``src`` to EPSG:``dst``.

    Composes through EPSG:4326 where needed (e.g. 3857 -> 3035, the path
    used in reference geocode_results.py:177-178).
    """
    if src == dst:
        return np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    if (src, dst) in _FWD:
        return _FWD[(src, dst)](x, y)
    if (src, 4326) in _FWD and (4326, dst) in _FWD:
        lon, lat = _FWD[(src, 4326)](x, y)
        return _FWD[(4326, dst)](lon, lat)
    raise ValueError(f"Unsupported CRS pair: {src} -> {dst}")
