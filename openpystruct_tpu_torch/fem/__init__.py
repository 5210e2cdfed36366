"""Batched beam FE model, block-tridiagonal solver and accuracy autopilot;
the 2D frame model with its banded solver and checked solve."""

from openpystruct_tpu_torch.fem.accuracy import (  # noqa: F401
    auto_refine,
    solve_beam_checked,
)
from openpystruct_tpu_torch.fem.beam import (  # noqa: F401
    BeamScenario,
    BeamSolution,
    assemble_beam_system,
    beam_min_pivot,
    constraint_mask,
    solve_beam,
    solve_beam_batched,
)
from openpystruct_tpu_torch.fem.frame import (  # noqa: F401
    FrameSolution,
    FrameStructure,
    build_frame,
    solve_frame,
)
from openpystruct_tpu_torch.fem.frame_banded import (  # noqa: F401
    frame_min_pivot,
    solve_frame_banded,
    solve_frame_checked,
)
from openpystruct_tpu_torch.fem.solve import (  # noqa: F401
    block_tridiag_min_pivot,
    block_tridiag_solve,
)
