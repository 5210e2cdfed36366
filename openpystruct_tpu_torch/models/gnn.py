"""Chain-GNN surrogate (port of ``models/gnn.py``).

Reference: ``precompute_normalized_adjacency`` + ``GCNLayer`` + ``ChainGNN``
(OpenPyStruct_GNN_MultiCase_Beta.py:249-349): flattened multi-case features
-> encoder MLP (Dense -> relu -> Dense) producing n_elem x hidden node
embeddings -> 2 pre-norm residual GCN layers over the path graph's dense
D^-1/2 A D^-1/2 -> a per-node scalar readout.  Trained with AdamW
(GNN_Beta.py:395; the family passes ``decoupled_weight_decay=True`` to
``fit``).

The flax modules' dtype rules (``models/layers.py``): float32 parameters
cast to ``dtype`` (bfloat16 in the family) at use, the adjacency in
``dtype``, LayerNorms in float32 cast back, a float32 readout.  Submodule
names follow the flax tree (``interop.gnn_params_from_flax``): ``dense_0``,
``dense_1`` the encoder, ``norm_i`` and ``dense_{2 + i}`` (no bias) GCN
block i, the last ``dense_`` the readout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    LN_EPS,
    dense,
    layer_norm,
    maybe_dropout,
    reset_flax_,
)


def normalized_chain_adjacency(n: int) -> np.ndarray:
    """Path-graph adjacency, symmetrically normalized
    (OpenPyStruct_GNN_MultiCase_Beta.py:249-262)."""
    A = np.zeros((n, n), dtype=np.float32)
    idx = np.arange(n - 1)
    A[idx, idx + 1] = 1.0
    A[idx + 1, idx] = 1.0
    d_inv_sqrt = (A.sum(axis=1) + 1e-8) ** -0.5
    return A * d_inv_sqrt[None, :] * d_inv_sqrt[:, None]


class ChainGNN(nn.Module):
    """``forward(x, generator=, train=False)`` takes (B, input_dim) or (B,
    n_cases, feat) (flattened, as the reference) and returns (B, n_elem)
    float32."""

    def __init__(self, input_dim: int, n_elem: int = 100,
                 encoder_hidden_dim: int = 128, gnn_hidden_dim: int = 128,
                 num_gnn_layers: int = 2, dropout_rate: float = 0.5,
                 dtype=torch.bfloat16):
        super().__init__()
        self.n_elem, self.gnn_hidden_dim = n_elem, gnn_hidden_dim
        self.num_gnn_layers = num_gnn_layers
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.dense_0 = nn.Linear(input_dim, encoder_hidden_dim)
        self.dense_1 = nn.Linear(encoder_hidden_dim, n_elem * gnn_hidden_dim)
        for i in range(num_gnn_layers):
            self.add_module(f"norm_{i}", nn.LayerNorm(gnn_hidden_dim,
                                                      eps=LN_EPS))
            self.add_module(f"dense_{2 + i}", nn.Linear(
                gnn_hidden_dim, gnn_hidden_dim, bias=False))
        self.add_module(f"dense_{2 + num_gnn_layers}",
                        nn.Linear(gnn_hidden_dim, 1))
        self.register_buffer("a_hat", torch.from_numpy(
            normalized_chain_adjacency(n_elem)), persistent=False)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        reset_flax_(self, generator)

    def forward(self, x, *, generator, train: bool = False):
        if x.ndim == 3:
            x = x.reshape(x.shape[0], -1)
        # encoder MLP -> node embeddings (GNN_Beta.py:305-310)
        h = torch.relu(dense(x, self.dense_0, self.dtype))
        out = dense(h, self.dense_1, self.dtype).reshape(
            x.shape[0], self.n_elem, self.gnn_hidden_dim)
        a_hat = self.a_hat.to(self.dtype)
        for i in range(self.num_gnn_layers):
            # pre-norm residual GCN block (GNN_Beta.py:341-345)
            h = layer_norm(out, getattr(self, f"norm_{i}"), self.dtype)
            h = dense(h, getattr(self, f"dense_{2 + i}"), self.dtype)
            h = torch.einsum("ij,bjd->bid", a_hat, h)
            out = out + maybe_dropout(h, self.dropout_rate, train, generator)
        readout = getattr(self, f"dense_{2 + self.num_gnn_layers}")
        return dense(out, readout, torch.float32).squeeze(-1)
