"""FNN-with-residual-blocks surrogate (port of ``models/fnn.py``).

Reference: ``ResidualBlock`` + ``FNNWithResidual``
(OpenPyStruct_FNN_MultiCase.py:330-380, instantiated with 4 blocks at
:472-478): input Linear -> LeakyReLU(0.01) -> Dropout -> 4 x [Linear +
LeakyReLU + Dropout + skip + LayerNorm + LeakyReLU] -> output Linear.  The
input is the flattened (n_cases * feat_dim) multi-case feature vector.

The flax modules' dtype rules (``models/layers.py``): float32 parameters
cast to ``dtype`` (bfloat16 in the family) at use, LayerNorms in float32
with epsilon 1e-6, a float32 head.  Submodule names follow the flax tree
(``interop.fnn_params_from_flax``).
"""

from __future__ import annotations

import torch
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    LN_EPS,
    dense,
    layer_norm,
    leaky_relu,
    maybe_dropout,
    reset_flax_,
)


class ResidualBlock(nn.Module):
    def __init__(self, dim: int, dropout_rate: float, dtype=torch.bfloat16):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.dense_0 = nn.Linear(dim, dim)
        self.norm_0 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, *, generator, train: bool):
        out = leaky_relu(dense(x, self.dense_0, self.dtype))
        out = maybe_dropout(out, self.dropout_rate, train, generator)
        out = layer_norm(out + x, self.norm_0, self.dtype)
        return leaky_relu(out)


class FNNWithResidual(nn.Module):
    """``forward(x, generator=, train=False)`` takes (B, input_dim) or (B,
    n_cases, feat) (flattened, as the reference's host-side reshape,
    OpenPyStruct_FNN_MultiCase.py:293) and returns (B, output_dim)
    float32."""

    def __init__(self, input_dim: int, hidden_dim: int = 128,
                 num_blocks: int = 4, output_dim: int = 100,
                 dropout_rate: float = 0.5, dtype=torch.bfloat16):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.dense_0 = nn.Linear(input_dim, hidden_dim)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_dim, dropout_rate, dtype)
            for _ in range(num_blocks))
        self.dense_1 = nn.Linear(hidden_dim, output_dim)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        reset_flax_(self, generator)

    def forward(self, x, *, generator, train: bool = False):
        if x.ndim == 3:
            x = x.reshape(x.shape[0], -1)
        out = leaky_relu(dense(x, self.dense_0, self.dtype))
        out = maybe_dropout(out, self.dropout_rate, train, generator)
        for block in self.blocks:
            out = block(out, generator=generator, train=train)
        return dense(out, self.dense_1, torch.float32)
