"""I-field optimization: loss and Adam loops."""

from openpystruct_tpu_torch.opt.beam_opt import (  # noqa: F401
    BeamOptResult,
    optimize_beam,
    optimize_beam_batched,
    optimize_beam_compact,
)
from openpystruct_tpu_torch.opt.loss import (  # noqa: F401
    LossComponents,
    structural_loss,
)
