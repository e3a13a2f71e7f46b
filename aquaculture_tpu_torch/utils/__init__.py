"""Shared utilities: checkpointing, logging, stage timing, profiling."""

from aquaculture_tpu_torch.utils.logging import get_logger, log_info, log_warning  # noqa: F401
from aquaculture_tpu_torch.utils.profiler import annotate, maybe_trace, trace_region  # noqa: F401
from aquaculture_tpu_torch.utils.timer import StageTimer  # noqa: F401
