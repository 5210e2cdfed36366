"""Surrogate model families (the reference's L4 layer): the FNN, the PINN,
the Transformer-Diffusion model and their losses.  The GNN, the FNO and the
Bayesian TFDs are not ported yet (ROADMAP queue A item 3)."""

from openpystruct_tpu_torch.models.fnn import (  # noqa: F401
    FNNWithResidual,
    ResidualBlock,
)
from openpystruct_tpu_torch.models.layers import BatchNorm  # noqa: F401
from openpystruct_tpu_torch.models.losses import (  # noqa: F401
    composite_pinn_loss,
    trainable_l1l2_loss,
)
from openpystruct_tpu_torch.models.pinn import (  # noqa: F401
    PINNResidualBlock,
    PINNWithResidual,
)
from openpystruct_tpu_torch.models.transformer_diffusion import (  # noqa: F401
    DiffusionModule,
    TransformerDiffusionModel,
    TransformerEncoderLayer,
    sincos_positional_encoding,
)
