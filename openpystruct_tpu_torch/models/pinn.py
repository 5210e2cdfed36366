"""PINN surrogate (port of ``models/pinn.py``): a conv-augmented residual
FNN and its composite loss.

Reference: ``ResidualBlock`` (a two-Linear bottleneck, a Conv1d(1, 1, 3) +
BatchNorm path and the skip) and ``FNNWithResidual(norm_type="batch" |
"layer")`` (OpenPyStruct_PINN_MultiCase.py:395-541); the output is 302 =
I (100) + deflections (101) + rotations (101) (PINN:35-56);
``CompositeLoss`` is TrainableL1L2 on the I slice plus ``penalty_pinn``
times the relative L1 of the deflection and rotation slices
(PINN:603-653).  No PDE residual is computed: the physics enters only
through the FEA-produced auxiliary targets.  The loss is
``losses.composite_pinn_loss``, imported here as in the JAX package.

flax's rules (``models/layers.py``): float32 parameters cast to ``dtype``
at use, norms in float32, a float32 head; BatchNorm is flax's (momentum 0.9
on the running side, biased variance, epsilon 1e-5), its running statistics
buffers updated by a ``train=True`` forward.  The conv is flax's
``Conv(features=1, kernel_size=3, padding="SAME")`` over the feature axis:
a cross-correlation padded by 1 on each side, the kernel not flipped (flax
stores it (3, 1, 1), torch's ``Conv1d`` weight is (1, 1, 3)); its BatchNorm
normalizes the one channel over (batch, length).  Submodule names follow the
flax tree (``interop.pinn_params_from_flax``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    LN_EPS,
    BatchNorm,
    dense,
    layer_norm,
    leaky_relu,
    maybe_dropout,
    reset_flax_,
)
from openpystruct_tpu_torch.models.losses import composite_pinn_loss  # noqa: F401


class PINNResidualBlock(nn.Module):
    """Linear bottleneck + single-channel 3-tap conv path + skip
    (OpenPyStruct_PINN_MultiCase.py:395-452)."""

    def __init__(self, dim: int, hidden_dim: int, dropout_rate: float,
                 dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.dense_0 = nn.Linear(dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, dim)
        self.conv = nn.Conv1d(1, 1, 3)
        self.norm_0 = BatchNorm(1)

    def forward(self, x, *, generator, train: bool):
        out = leaky_relu(dense(x, self.dense_0, self.dtype))
        out = maybe_dropout(out, self.dropout_rate, train, generator)
        out = dense(out, self.dense_1, self.dtype)
        c = F.conv1d(x.to(self.dtype)[:, None, :],
                     self.conv.weight.to(self.dtype),
                     self.conv.bias.to(self.dtype), padding=1)
        # (B, 1, dim) -> (B, dim, 1): one channel, normalized over
        # (batch, length)
        c = self.norm_0(c.transpose(1, 2), train=train)
        return out + c.squeeze(-1).to(self.dtype) + x


class PINNWithResidual(nn.Module):
    """The PINN's FNNWithResidual (OpenPyStruct_PINN_MultiCase.py:454-541):
    input Dense -> norm -> LeakyReLU -> Dropout -> num_blocks x
    [PINNResidualBlock -> norm] -> output Dense (302 by default).
    ``forward(x, generator=, train=False)`` takes (B, input_dim) or (B,
    n_cases, feat) and returns (B, output_dim) float32."""

    def __init__(self, input_dim: int, hidden_dim: int = 350,
                 num_blocks: int = 2, output_dim: int = 302,
                 dropout_rate: float = 0.5, norm_type: str = "batch",
                 dtype=torch.float32):
        super().__init__()
        if norm_type not in ("batch", "layer"):
            raise ValueError("Invalid norm_type. Use 'batch' or 'layer'.")
        self.dropout_rate, self.norm_type, self.dtype = (
            dropout_rate, norm_type, dtype)
        self.dense_0 = nn.Linear(input_dim, hidden_dim)
        for i in range(num_blocks + 1):
            self.add_module(f"norm_{i}", BatchNorm(hidden_dim)
                            if norm_type == "batch"
                            else nn.LayerNorm(hidden_dim, eps=LN_EPS))
        self.blocks = nn.ModuleList(
            PINNResidualBlock(hidden_dim, hidden_dim // 2, dropout_rate,
                              dtype=dtype)
            for _ in range(num_blocks))
        self.dense_1 = nn.Linear(hidden_dim, output_dim)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        reset_flax_(self, generator)

    def _norm(self, i, x, train):
        norm = getattr(self, f"norm_{i}")
        if self.norm_type == "batch":
            return norm(x, train=train).to(self.dtype)
        return layer_norm(x, norm, self.dtype)

    def forward(self, x, *, generator, train: bool = False):
        if x.ndim == 3:
            x = x.reshape(x.shape[0], -1)
        out = self._norm(0, dense(x, self.dense_0, self.dtype), train)
        out = maybe_dropout(leaky_relu(out), self.dropout_rate, train,
                            generator)
        for i, block in enumerate(self.blocks):
            out = block(out, generator=generator, train=train)
            out = self._norm(i + 1, out, train)
        return dense(out, self.dense_1, torch.float32)
