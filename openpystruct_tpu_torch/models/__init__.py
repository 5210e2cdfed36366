"""Surrogate model families (the reference's L4 layer): the
Transformer-Diffusion model and the shared loss.  The other six families
are not ported yet (ROADMAP queue A item 3)."""

from openpystruct_tpu_torch.models.losses import trainable_l1l2_loss  # noqa: F401
from openpystruct_tpu_torch.models.transformer_diffusion import (  # noqa: F401
    DiffusionModule,
    TransformerDiffusionModel,
    TransformerEncoderLayer,
    sincos_positional_encoding,
)
