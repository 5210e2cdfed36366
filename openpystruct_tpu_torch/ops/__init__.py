"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""

from openpystruct_tpu_torch.ops.block_stream import (  # noqa: F401
    block_tridiag_solve_streamed,
)
from openpystruct_tpu_torch.ops.block_tridiag import (  # noqa: F401
    block_tridiag_solve,
    solve_sym,
)
