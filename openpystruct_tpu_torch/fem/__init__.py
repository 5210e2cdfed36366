"""Batched beam FE model, block-tridiagonal solver and accuracy autopilot."""

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
from openpystruct_tpu_torch.fem.solve import (  # noqa: F401
    block_tridiag_min_pivot,
    block_tridiag_solve,
)
