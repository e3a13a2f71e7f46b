"""Tonnage estimation engine: production factors, model-error distributions,
Monte-Carlo bootstrap, bathymetry depth, multi-year dedup, AquaFacility.

The statistical core of the reference (reference: src/utils_tonnage.py,
1224 LoC), a copy of aquaculture_tpu/tonnage: the K=10,000 bootstrap runs as
vectorized PyTorch tensor code over a (K, cages) lattice on the entry
point's device instead of a Python loop of pandas copies, and
rejection-resampling loops are replaced by their exact
truncated-distribution equivalents. The rest is host numpy and pandas.
"""

from aquaculture_tpu_torch.tonnage.factors import (  # noqa: F401
    generate_period_production_factors,
    load_fao_french_mediterranean,
    load_production_factors,
)
from aquaculture_tpu_torch.tonnage.errors import (  # noqa: F401
    define_model_error_distributions,
    get_cage_area_errors_from_labels,
)
from aquaculture_tpu_torch.tonnage.bootstrap import compute_facility_tonnage_estimates  # noqa: F401
from aquaculture_tpu_torch.tonnage.depth import add_facility_depth  # noqa: F401
from aquaculture_tpu_torch.tonnage.dedup_years import (  # noqa: F401
    dedup_cages_in_overlap_years_with_white_space,
)
from aquaculture_tpu_torch.tonnage.facility import (  # noqa: F401
    AquaFacility,
    CF_Facility,
    compute_complete_period_tonnage_estimates,
    load_AquaFacility,
)
from aquaculture_tpu_torch.tonnage.periods import map_year_to_image_pass  # noqa: F401
