"""Facility tonnage bootstrap: K=10,000 Monte-Carlo as tensor code on the
entry point's device.

A copy of aquaculture_tpu/tonnage/bootstrap.py (reference:
src/utils_tonnage.py:28-127 and sample_model_errors :330-458) whose
simulation runs as PyTorch tensor code over a (K, n_cages) /
(K, n_facilities) lattice on ``device`` (the GPU by default), in float32
as the JAX package computes it:

* model-error "resample until area > 0" loop -> exact truncated normal with
  lower bound -area_orig (rejection sampling from N conditioned on
  area > 0 IS that truncated normal)
* per-cage min/max-area rebounds (circle 4A/(2+pi)..2piA/(2+pi), square
  2A/3..4A/3; utils_tonnage.py:405-436)
* masked segment sums aggregate cages -> facilities under the min / max
  selections (the cage_ids_min/max columns)
* facility area ~ U(min, max); depth ~ Bernoulli mixture of two truncated
  normals on [min_thresh, d] and [d, 2d]; stocking ~ TN(s, [5, 20]);
  harvest ~ N(h); tonnage = area*depth*stock*harvest/1000
* period totals via one more segment sum; mean/var over the K axis

Every draw comes from one ``torch.Generator`` on the device, seeded with
``seed``, in a fixed order, and every sum has a fixed order (a sorted
segment sum, never atomics): one seed on one device gives the same table
bit for bit. The draws are not ``jax.random``'s, and the CPU and CUDA
generators differ from each other, so across packages or devices the
tables agree within Monte-Carlo error.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import pandas as pd
import torch

from aquaculture_tpu_torch.config import resolve_device

STOCKING_BOUNDS = (5.0, 20.0)
_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass
class BootstrapInputs:
    """Flat arrays describing the facility/cage lattice (host-prepared)."""

    # cage level (n pairs of facility x cage under any selection)
    cage_fac: np.ndarray        # (n,) facility row index
    area_orig: np.ndarray       # (n,)
    var_zero_circle: np.ndarray # (n,) bool: circle with zero variance
    is_circle: np.ndarray       # (n,) bool
    err_mean: np.ndarray        # (n,)
    err_sd: np.ndarray          # (n,)
    in_min: np.ndarray          # (n,) bool
    in_max: np.ndarray          # (n,) bool
    in_random: np.ndarray       # (n,) bool
    # facility level
    fac_period: np.ndarray      # (m,) period index
    cage_depth: np.ndarray      # (m,)
    s_mean: np.ndarray
    s_sd: np.ndarray
    h_mean: np.ndarray
    h_sd: np.ndarray
    periods: List                # period labels, index = period id


def _id_lists(column: pd.Series):
    """(facility row, cage id) pairs of one selection column, in row order;
    a missing list (None or NaN) contributes nothing."""
    fis, cids = [], []
    for fi, ids in enumerate(column):
        if ids is None or (isinstance(ids, float) and np.isnan(ids)):
            continue
        ids = np.asarray(ids, np.int64).reshape(-1)
        fis.append(np.full(len(ids), fi, np.int64))
        cids.append(ids)
    if not fis:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(fis), np.concatenate(cids)


def prepare_bootstrap_inputs(
    facility_df: pd.DataFrame,
    preds_df: pd.DataFrame,
    model_error_distributions: pd.DataFrame,
    period_factor_table: pd.DataFrame,
    period_var: str,
) -> BootstrapInputs:
    """Flatten the facility frame (with cage_ids / cage_ids_min /
    cage_ids_max lists) into the bootstrap lattice: one row per distinct
    (facility row, cage id) pair in sorted order, as the JAX package's
    loop builds it, with whole-array lookups in place of its per-pair
    ``.loc``."""
    est = facility_df.merge(period_factor_table, how="left", on=[period_var])
    est = est.reset_index(drop=True)

    periods = sorted(pd.unique(est["pass"]))
    period_id = {p: i for i, p in enumerate(periods)}

    none = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    sels = [_id_lists(est[col]) if col in est.columns else none
            for col in ("cage_ids_min", "cage_ids_max", "cage_ids")]
    pairs = np.concatenate([np.stack(s, 1) for s in sels]).reshape(-1, 2)
    keys, inverse = np.unique(pairs, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n = len(keys)
    flags = np.zeros((3, n), bool)
    start = 0
    for j, (fi, _) in enumerate(sels):
        flags[j, inverse[start:start + len(fi)]] = True
        start += len(fi)
    cage_fac, cid = keys[:, 0], keys[:, 1]

    cages = preds_df.set_index("index")
    pos = cages.index.get_indexer(cid)
    if (pos < 0).any():
        raise KeyError(f"cage ids not in the predictions: {sorted(set(cid[pos < 0].tolist()))[:10]}")
    ftype = cages["farm_type"].to_numpy()[pos]
    area = cages["area"].to_numpy(np.float64)[pos]
    area_var = cages["area_var"].to_numpy(np.float64)[pos]
    fac_pass = est["pass"].to_numpy()[cage_fac]
    err = {}
    for p, ft, mu, sd in zip(model_error_distributions["pass"], model_error_distributions["farm_type"],
                             model_error_distributions["model_error_mean"],
                             model_error_distributions["model_error_sd"]):
        err[(p, ft)] = (float(mu), float(sd))
    musd = np.asarray([err.get((p, ft), (0.0, 0.0)) for p, ft in zip(fac_pass, ftype)],
                      np.float64).reshape(-1, 2)
    is_circle = ftype == "circle_farm"
    return BootstrapInputs(
        cage_fac=cage_fac.astype(np.int32),
        area_orig=area,
        var_zero_circle=is_circle & (area_var == 0.0),
        is_circle=is_circle,
        err_mean=musd[:, 0].copy(),
        err_sd=musd[:, 1].copy(),
        in_min=flags[0].copy(),
        in_max=flags[1].copy(),
        in_random=flags[2].copy(),
        fac_period=np.asarray([period_id[p] for p in est["pass"]], np.int32),
        cage_depth=est["cage_depth"].to_numpy(np.float64),
        s_mean=est["s_mean"].to_numpy(np.float64),
        s_sd=est["s_sd"].to_numpy(np.float64),
        h_mean=est["h_mean"].to_numpy(np.float64),
        h_sd=est["h_sd"].to_numpy(np.float64),
        periods=periods,
    )


def _truncnorm(gen, lower, upper, loc, scale, shape):
    """Truncated normal on [lower, upper] in standardized units of (loc,
    scale); degenerate scale collapses to loc. ``jax.random.truncated_normal``'s
    formula in float32: a uniform on [erf(lower/sqrt2), erf(upper/sqrt2)),
    sqrt2 * erfinv of it, clipped to the open interval; the bounds are
    per element and may be infinite."""
    dev = loc.device
    lower = torch.as_tensor(lower, dtype=torch.float32, device=dev)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=dev)
    a = torch.special.erf(lower / _SQRT2)
    b = torch.special.erf(upper / _SQRT2)
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    u = torch.maximum(a, u * (b - a) + a)
    z = _SQRT2 * torch.special.erfinv(u)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    z = torch.clamp(z, torch.nextafter(lower, inf), torch.nextafter(upper, -inf))
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.where(scale > 0, loc + z * safe_scale, loc)


def _segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(K, n) -> (K, segments): sums of consecutive column runs of the
    given lengths, each in a fixed order (no atomics: the same inputs give
    the same bits on every run)."""
    return torch.segment_reduce(vals, "sum", lengths=lengths.expand(vals.shape[0], -1).contiguous(),
                                axis=1, unsafe=True)


def run_bootstrap(
    inputs: BootstrapInputs,
    seed: int,
    K: int,
    min_cage_threshold: float,
    depth_dist_mixture_param: float,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Run the vectorized bootstrap on ``device``; returns per-period
    tonnage mean/var/sd indexed by 'pass' (the reference's
    period_estimates frame)."""
    n = len(inputs.cage_fac)
    m = len(inputs.cage_depth)
    n_periods = len(inputs.periods)
    dev = resolve_device(device)
    if n == 0 or m == 0:
        return pd.DataFrame(
            {"tonnage": [0.0] * n_periods, "tonnage_var": [0.0] * n_periods,
             "tonnage_sd": [0.0] * n_periods},
            index=pd.Index(inputs.periods, name="pass"),
        )

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def flag(a):
        return torch.from_numpy(np.asarray(a, bool)).to(dev)

    cage_fac = np.asarray(inputs.cage_fac, np.int64)
    if (np.diff(cage_fac) < 0).any():
        raise ValueError("cage_fac must be sorted (prepare_bootstrap_inputs sorts the lattice)")
    cage_lengths = torch.from_numpy(np.bincount(cage_fac, minlength=m)).to(dev)
    fac_period = np.asarray(inputs.fac_period, np.int64)
    period_order = torch.from_numpy(np.argsort(fac_period, kind="stable")).to(dev)
    period_lengths = torch.from_numpy(np.bincount(fac_period, minlength=n_periods)).to(dev)

    area_orig = f32(inputs.area_orig)
    err_mean = f32(inputs.err_mean)
    err_sd = f32(inputs.err_sd)
    vzc = flag(inputs.var_zero_circle)
    is_circle = flag(inputs.is_circle)
    # in_random is deliberately NOT consumed: the simulated facility area
    # is U(min-selection sum, max-selection sum), so the random selection
    # never enters the bootstrap — the reference says the same
    # (utils_tonnage.py:437-439 "is not used in the bootstrap").
    in_min = flag(inputs.in_min)
    in_max = flag(inputs.in_max)
    depth = f32(inputs.cage_depth)
    s_mean, s_sd = f32(inputs.s_mean), f32(inputs.s_sd)
    h_mean, h_sd = f32(inputs.h_mean), f32(inputs.h_sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)

    with torch.no_grad():
        # 1. cage-level model error, truncated so area stays positive
        #    (exact form of the reference's resample-until-positive loop)
        sd_pos = err_sd > 0
        lo = torch.where(sd_pos, (-area_orig - err_mean) / torch.where(sd_pos, err_sd, 1.0), -inf)
        err = _truncnorm(gen, lo, inf, err_mean[None, :], err_sd[None, :], (K, n))
        area = area_orig[None, :] + err
        del err

        # 2. per-cage area bounds by type (utils_tonnage.py:405-436)
        min_a = torch.where(vzc, area,
                            torch.where(is_circle, 4.0 * area / (2.0 + math.pi), 2.0 * area / 3.0))
        fac_min = _segment_sum(torch.where(in_min, min_a, zero), cage_lengths)
        del min_a
        max_a = torch.where(vzc, area,
                            torch.where(is_circle, 2.0 * math.pi * area / (2.0 + math.pi), 4.0 * area / 3.0))
        del area
        # 3. facility aggregation per selection (masked segment sums)
        fac_max = _segment_sum(torch.where(in_max, max_a, zero), cage_lengths)
        del max_a

        # 4. facility area ~ U(min, max)
        u = torch.rand((K, m), generator=gen, device=dev, dtype=torch.float32)
        sim_area = fac_min + u * (fac_max - fac_min)

        # 5. depth: mixture of truncated normals around cage_depth
        c = depth[None, :]
        sA = (depth - min_cage_threshold) / 1.96
        lo_a = torch.where(sA > 0, (min_cage_threshold - depth) / torch.where(sA > 0, sA, 1.0), 0.0)
        dA = _truncnorm(gen, lo_a[None, :], 0.0, c, sA[None, :], (K, m))
        sB = depth / 1.96
        dB = _truncnorm(gen, 0.0, 1.96, c, sB[None, :], (K, m))

        # 6. stocking density ~ TN(s_mean, s_sd, [5, 20]); harvest ~ N
        s_scale = torch.where(s_sd > 0, s_sd, 1.0)
        lo_s = (STOCKING_BOUNDS[0] - s_mean) / s_scale
        hi_s = (STOCKING_BOUNDS[1] - s_mean) / s_scale
        sim_stock = _truncnorm(gen, lo_s[None, :], hi_s[None, :], s_mean[None, :], s_sd[None, :], (K, m))
        sim_harv = h_mean[None, :] + h_sd[None, :] * torch.randn((K, m), generator=gen, device=dev,
                                                                 dtype=torch.float32)
        bern = torch.rand((K, m), generator=gen, device=dev, dtype=torch.float32) < depth_dist_mixture_param
        sim_depth = torch.where(bern, dA, dB)

        # 7. tonnage and period totals
        tonnage = sim_area * sim_depth * sim_stock * sim_harv / 1000.0
        per_period = _segment_sum(tonnage[:, period_order], period_lengths)  # (K, n_periods)
        var, mean = torch.var_mean(per_period, dim=0, correction=0)
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    out = pd.DataFrame(
        {"tonnage": mean, "tonnage_var": var, "tonnage_sd": np.sqrt(var)},
        index=pd.Index(inputs.periods, name="pass"),
    )
    return out.sort_index()


def compute_facility_tonnage_estimates(
    facility_df: pd.DataFrame,
    period_factor_table: pd.DataFrame,
    period_var: str,
    min_cage_threshold: float,
    preds_df: pd.DataFrame,
    model_error_distributions: pd.DataFrame,
    depth_dist_mixture_param: float,
    K: int = 10_000,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> pd.DataFrame:
    """Reference-compatible wrapper (utils_tonnage.py:28-127 signature):
    facility frame + factor table -> per-period tonnage mean/var/sd, the
    bootstrap on ``device``."""
    from aquaculture_tpu_torch.tonnage.factors import factor_columns_for_bootstrap

    pft = factor_columns_for_bootstrap(period_factor_table)
    fac = facility_df.copy()
    if "cage_ids_min" not in fac.columns:
        fac["cage_ids_min"] = fac["cage_ids"]
    if "cage_ids_max" not in fac.columns:
        fac["cage_ids_max"] = fac["cage_ids"]
    if "farm_type" not in preds_df.columns:
        preds_df = preds_df.copy()
        preds_df["farm_type"] = preds_df["type"]
    inputs = prepare_bootstrap_inputs(fac, preds_df, model_error_distributions, pft, period_var)
    return run_bootstrap(inputs, seed, K, min_cage_threshold, depth_dist_mixture_param, device=device)
