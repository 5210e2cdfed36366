"""Shared surrogate-training harness (replaces the reference's seven
copy-pasted training loops, OpenPyStruct_FNN_MultiCase.py:480-594 et al.)."""

from openpystruct_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from openpystruct_tpu_torch.train.harness import (  # noqa: F401
    FitResult,
    evaluate_r2,
    fit,
    predict,
)
