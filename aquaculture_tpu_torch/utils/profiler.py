"""Profiler integration on ``torch.profiler``.

Counterpart of aquaculture_tpu/utils/profiler.py: wrap any pipeline region
in a trace of host (CPU) activity and, where a GPU is present, the card's
(CUDA kernels, copies), or annotate host spans.

    with trace_region("/tmp/tb"):
        run_pipeline(...)
    # then open /tmp/tb/*.pt.trace.json in Perfetto (ui.perfetto.dev) or
    # TensorBoard's profile plugin

The trace is the Chrome-trace JSON that
``torch.profiler.tensorboard_trace_handler`` writes into ``logdir``, one
file per region. The JAX function's ``create_perfetto_link`` has no
counterpart here and is not taken.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Iterator


@contextmanager
def trace_region(logdir: str) -> Iterator[None]:
    """Capture a host + device profile of the enclosed region into
    ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def maybe_trace(logdir: str | None):
    """``trace_region(logdir)`` when logdir is set, else a no-op context.

    The one-liner behind every CLI's ``--profile LOGDIR`` flag."""
    if logdir:
        return trace_region(logdir)
    return nullcontext()


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named host span visible in the trace viewer."""
    from torch.profiler import record_function

    with record_function(name):
        yield
