"""Results layer of the PyTorch port: the paper's Figure-3 precision/recall
sweep (performance.py), the zero-label stratum's upper bound
(upper_bound.py) and the figure styling (style.py), copies of the JAX
package's. The maps and the tonnage report need the overlay engine and come
with a later slice.
"""

from aquaculture_tpu_torch.results.performance import (  # noqa: F401
    stats_at_thresholds,
    plot_precision_recall_curves,
)
from aquaculture_tpu_torch.results.upper_bound import upper_bound_simulation  # noqa: F401
