"""Observability utilities: metrics, logging, profiling."""

from openpystruct_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    Timer,
    steps_per_sec,
)
from openpystruct_tpu_torch.utils.profiling import profile_trace  # noqa: F401
