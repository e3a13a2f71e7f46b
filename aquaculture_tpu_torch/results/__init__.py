"""Results layer of the PyTorch port: the paper's Figure-3 precision/recall
sweep (performance.py), the zero-label stratum's upper bound
(upper_bound.py), the figure styling (style.py), the Figure-6 tonnage
report (tonnage_report.py) and the facility maps (maps.py: the Trujillo
classifications, unique locations, the map figures and the HTML map),
copies of the JAX package's.
"""

from aquaculture_tpu_torch.results.performance import (  # noqa: F401
    stats_at_thresholds,
    plot_precision_recall_curves,
)
from aquaculture_tpu_torch.results.upper_bound import upper_bound_simulation  # noqa: F401
