"""Deprecated shim: the profiler lives in the observability plane.

Counterpart of ``tensorflowonspark_tpu/utils/profiler.py``: re-exports
``tensorflowonspark_tpu_torch.obs.profiler``'s surface so the old import
path keeps working; new code imports from ``obs.profiler``.
"""

import warnings

from tensorflowonspark_tpu_torch.obs.profiler import (  # noqa: F401
    PEAK_BF16_FLOPS,
    StepTimer,
    annotate,
    device_memory_stats,
    mfu,
    resolve_chip_generation,
    start_server,
    trace,
    transformer_flops_per_token,
)

warnings.warn(
    "tensorflowonspark_tpu_torch.utils.profiler moved to "
    "tensorflowonspark_tpu_torch.obs.profiler; this shim will be removed",
    DeprecationWarning, stacklevel=2)
