"""I-field optimization: loss and Adam loops, beams and frames."""

from openpystruct_tpu_torch.opt.beam_opt import (  # noqa: F401
    BeamOptResult,
    optimize_beam,
    optimize_beam_batched,
    optimize_beam_compact,
)
from openpystruct_tpu_torch.opt.frame_opt import (  # noqa: F401
    FrameOptResult,
    frame_loss,
    optimize_frame,
    optimize_frame_batched,
)
from openpystruct_tpu_torch.opt.loss import (  # noqa: F401
    LossComponents,
    structural_loss,
)
