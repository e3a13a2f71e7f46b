"""Production factors: species parameters + FAO production-share weighting.
A copy of aquaculture_tpu/tonnage/factors.py in the PyTorch port.

Port of the reference's factor-table construction (reference:
src/utils_tonnage.py:461-588): per-species stocking density and harvest
frequency with uniform-range standard deviations, FAO French-Mediterranean
production shares 2000-2020, and the production-share-weighted period table
feeding the bootstrap.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import pandas as pd

from aquaculture_tpu_torch.utils.xlsx import read_xlsx

_COLS = ["Species", "Parameter", "Factor", "Range (lower)", "Range (upper)"]
SPECIES_GROUPS = ("seabass", "seabream", "meagre")


def load_production_factors(prod_file: str) -> pd.DataFrame:
    """Species-level factor table with uniform-range standard deviations
    (reference utils_tonnage.py:461-501)."""
    pf = read_xlsx(prod_file, sheet_name="Production Factors")
    pf["Species"] = pf["Species"].str.lower()
    for c in ("Factor", "Range (lower)", "Range (upper)"):
        pf[c] = pd.to_numeric(pf[c], errors="coerce")

    sd = pf[pf["Factor Type"] == "Stocking density"].copy()
    sd["Parameter"] = "Stocking density"

    hf = pf[pf["Factor Type"] == "Harvest frequency"].copy()
    # months-between-harvests -> annual frequency
    for c in ("Factor", "Range (lower)", "Range (upper)"):
        hf[c] = 12.0 / hf[c]
    hf["Parameter"] = "Annual harvest frequency"

    table = pd.concat([sd[_COLS], hf[_COLS]], ignore_index=True)
    # Uniform-over-range variance: (b - a)^2 / 12
    table["Standard deviation"] = np.sqrt(
        np.square(table["Range (upper)"] - table["Range (lower)"]) / 12.0
    )
    return table


def load_fao_french_mediterranean(fao_file: str, pass_map: Callable) -> pd.DataFrame:
    """FAO French-Mediterranean production 2000+ in long format with
    species groups and annual production shares
    (reference utils_tonnage.py:504-551)."""
    fao = pd.read_csv(fao_file, header=0)
    fao = fao[~fao["FAO major fishing area (Name)"].isna()]
    fao = fao.rename(columns={"ASFIS species (Name)": "species"})
    # drop the per-year status columns (names containing 'S'; reference :520)
    fao = fao.drop(columns=fao.filter(regex="S").columns)

    id_vars = [
        "Country (Name)",
        "FAO major fishing area (Name)",
        "Environment (Name)",
        "species",
        "Unit (Name)",
        "Unit",
    ]
    long = fao.melt(id_vars=id_vars, var_name="year", value_name="production_quantity")
    long["year"] = long["year"].str.replace("[", "", regex=False).str.replace("]", "", regex=False)
    long["year"] = long["year"].astype(int)
    long = long[long["year"] >= 2000]
    long["pass"] = long["year"].map(pass_map)

    long["species_group"] = None
    for group in SPECIES_GROUPS:
        long.loc[long["species"].str.contains(group, case=False), "species_group"] = group
    long.loc[long["species"].str.contains("marine fishes nei", case=False), "species_group"] = "seabream"
    long = long[long["species_group"].isin(SPECIES_GROUPS)]

    long["production_share"] = long["production_quantity"] / long.groupby("year")[
        "production_quantity"
    ].transform("sum")
    long["production_quantity"] = long["production_quantity"].fillna(0)
    long["production_share"] = long["production_share"].fillna(0)
    return long


def generate_period_production_factors(
    production_factor_table: pd.DataFrame, fao_data: pd.DataFrame, period_var: str
) -> pd.DataFrame:
    """Production-share-weighted per-period factor table
    (reference utils_tonnage.py:554-588). Output columns:
    period_var, 'Factor <param>', 'Standard deviation <param>'."""
    agg = (
        fao_data.groupby([period_var, "species_group"])[["production_quantity"]]
        .sum()
        .reset_index()
    )
    totals = agg.groupby(period_var)["production_quantity"].transform("sum")
    agg["production_share"] = agg["production_quantity"] / totals

    merged = agg.merge(
        production_factor_table, left_on="species_group", right_on="Species", how="left"
    )

    def wm(x):
        return np.average(x, weights=merged.loc[x.index, "production_share"])

    def wsd(x):
        w = merged.loc[x.index, "production_share"]
        return float(np.sqrt(np.dot(np.square(x), np.square(w))))

    out = (
        merged.groupby([period_var, "Parameter"])
        .agg({"Factor": wm, "Standard deviation": wsd})
        .reset_index()
    )
    out = out.pivot_table(
        index=[period_var], columns=["Parameter"], values=["Factor", "Standard deviation"]
    ).reset_index()
    out.columns = [f"{x} {y}" if y != "" else x for x, y in out.columns]
    return out


def factor_columns_for_bootstrap(period_factor_table: pd.DataFrame) -> pd.DataFrame:
    """Rename the pivoted factor columns to the bootstrap's short names:
    s_mean/s_sd (stocking density), h_mean/h_sd (harvest frequency)."""
    return period_factor_table.rename(
        columns={
            "Factor Stocking density": "s_mean",
            "Standard deviation Stocking density": "s_sd",
            "Factor Annual harvest frequency": "h_mean",
            "Standard deviation Annual harvest frequency": "h_sd",
        }
    )
