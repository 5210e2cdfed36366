"""Observability utilities: metrics, logging, profiling."""

from openpystruct_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
from openpystruct_tpu_torch.utils.profiling import profile_trace  # noqa: F401
