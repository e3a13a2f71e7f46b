"""Upper bound on the cage population of the zero-label stratum (a copy of
aquaculture_tpu/results/upper_bound.py; numpy's generator, so the draws
equal the JAX package's).

Port of the reference's R simulation (reference:
src/Results/upper_bound_calculation.R): for candidate per-image cage rates,
simulate K binomial samples of the S_6 sampled images and record the median
number of labeled images; the smallest rate whose median is nonzero anchors
the population bound. Vectorized: the (rates x K) lattice is one binomial
draw instead of nested R loops.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pandas as pd

# Stratum parameters (upper_bound_calculation.R:8-9)
I_6 = 783_355
S_6 = 10_518


def upper_bound_simulation(
    rates: Sequence[float] = tuple(np.arange(1e-5, 1.05e-4, 1e-5)),
    K: int = 10_000,
    n_samples: int = S_6,
    n_images: int = I_6,
    cages_per_image: float = 5.0,
    labeled_cages_other_strata: int = 4_010,
    seed: int = 0,
) -> dict:
    """Returns the rate table and the population upper bound."""
    rng = np.random.default_rng(seed)
    rates = np.asarray(list(rates), np.float64)
    # labels ~ Binomial(S_6, r) per (rate, sim): median over sims
    draws = rng.binomial(n_samples, rates[:, None], size=(len(rates), K))
    med = np.sort(draws, axis=1)[:, K // 2]
    table = pd.DataFrame({"rate": rates, "all_zeros_50": med})

    nonzero = table[table["all_zeros_50"] > 0]
    final_r = float(nonzero["rate"].iloc[0]) if len(nonzero) else float(rates[-1])
    num_images_with_cages = round(final_r * n_images)
    pop_estimate_stratum = num_images_with_cages * cages_per_image
    return {
        "rate_table": table,
        "final_rate": final_r,
        "num_images_with_cages": num_images_with_cages,
        "population_estimate_stratum": pop_estimate_stratum,
        "population_upper_bound_total": pop_estimate_stratum + labeled_cages_other_strata,
    }
