"""Surrogate model families (the reference's L4 layer): the FNN, the PINN,
the FNO, the chain GNN, the Transformer-Diffusion model, its Bayesian
variants and their losses."""

from openpystruct_tpu_torch.models.bayesian import (  # noqa: F401
    BayesianDiffusionModule,
    BayesianDiffusionMLP,
    BayesianOutputMLP,
    BayesianTransformerDiffusionModel,
    BayesLinear,
    bayes_kl,
    mc_output_stats,
)
from openpystruct_tpu_torch.models.fnn import (  # noqa: F401
    FNNWithResidual,
    ResidualBlock,
)
from openpystruct_tpu_torch.models.fno import (  # noqa: F401
    FNO1dModel,
    FNOBlock1d,
    SpectralConv1d,
)
from openpystruct_tpu_torch.models.gnn import (  # noqa: F401
    ChainGNN,
    normalized_chain_adjacency,
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
