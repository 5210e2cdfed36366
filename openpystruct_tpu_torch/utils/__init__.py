"""Utilities: metrics and timing."""

from openpystruct_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    Timer,
    steps_per_sec,
)
