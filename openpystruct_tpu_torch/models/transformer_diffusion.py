"""Transformer-Diffusion surrogate (port of ``models/transformer_diffusion.py``).

Reference: ``PositionalEncoding`` (odd-dim-safe sin/cos),
``DiffusionSchedule`` (linear beta 1e-12 -> 1e-5, T = 512),
``DiffusionModule`` (random t per (B, case), forward noise, an MLP predicts
epsilon, one algebraic denoise step, at train AND eval time) and
``ModelOnePassTransformerWithDiffusion`` (diffusion -> prepend CLS ->
positional encoding -> 2-layer post-LN encoder, d_model = feat_dim, 8 heads,
ff 256 -> CLS representation -> MLP -> n_elem)
(OpenPyStruct_TransformerDiffusionModule_MultiCase.py:383-575).

Precision follows the flax modules' ``dtype`` field, not a global autocast:
parameters are float32 and cast to ``dtype`` where a dense layer or the
attention uses them; the attention's logits and softmax are in ``dtype``;
every LayerNorm computes in float32 (epsilon 1e-6, flax's) and casts back;
the output head is float32.  The input is cast to ``dtype`` first and the
diffusion schedule is built in it, as the JAX package does: in bfloat16
``1 - beta`` rounds to 1, so ``alpha_cumprod`` is 1, no noise is added and
the MLP's epsilon prediction is multiplied by 0 (the diffusion step is an
exact identity); in float32 the noise scale reaches 0.0506.

Randomness (the diffusion ``t`` and epsilon, dropout masks) is drawn from the
``generator`` the caller passes.  Parameters start from flax's
distributions (``reset_parameters``): lecun-normal kernels (a normal
truncated at 2 sigma, variance 1 / fan_in), zero biases, unit LayerNorm
scales, ``cls_token`` normal(0.02).  Submodule names follow the flax tree
(``interop.tfd_params_from_flax``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    LN_EPS,
    dense,
    dropout,
    layer_norm,
    maybe_dropout,
    reset_flax_,
)


def sincos_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Odd-dim-safe sin/cos table (reference TFD:383-417)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    n_pairs = d_model // 2
    div_term = np.exp(
        -math.log(10000.0) * np.arange(n_pairs, dtype=np.float32) / d_model
    )
    pe[:, 0 : 2 * n_pairs : 2] = np.sin(position * div_term)
    pe[:, 1 : 2 * n_pairs : 2] = np.cos(position * div_term)
    return pe  # odd d_model: last column stays zero


def diffusion_noise(x, t, eps, T: int, beta_start: float, beta_end: float):
    """The forward noise at steps ``t`` (B, case) of the linear beta
    schedule, built in x's dtype: (x_noisy, sqrt(ac_t), sqrt(1 - ac_t)),
    x_noisy = sqrt(ac_t) x + sqrt(1 - ac_t) eps."""
    beta = torch.linspace(beta_start, beta_end, T, dtype=x.dtype,
                          device=x.device)
    alpha_cumprod = torch.cumprod(1.0 - beta, dim=0)
    sac = torch.sqrt(alpha_cumprod[t])[..., None]
    somac = torch.sqrt(1.0 - alpha_cumprod[t])[..., None]
    return sac * x + somac * eps, sac, somac


class DiffusionModule(nn.Module):
    """Single-pass stochastic noise/denoise (reference TFD:428-476)."""

    def __init__(self, feat_dim: int, hidden_dim: int = 256, T: int = 512,
                 beta_start: float = 1e-12, beta_end: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.T, self.beta_start, self.beta_end = T, beta_start, beta_end
        self.dtype = dtype
        self.dense_0 = nn.Linear(feat_dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, feat_dim)

    def _draw(self, x, generator):
        """The diffusion step ``t`` per (B, case) and the noise epsilon."""
        t = torch.randint(0, self.T, x.shape[:2], generator=generator,
                          device=x.device)
        eps = torch.randn(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype)
        return t, eps

    def forward(self, x, generator):
        t, eps = self._draw(x, generator)
        x_noisy, sac, somac = diffusion_noise(x, t, eps, self.T,
                                              self.beta_start, self.beta_end)
        h = torch.relu(dense(x_noisy, self.dense_0, self.dtype))
        eps_pred = dense(h, self.dense_1, self.dtype)
        return (x_noisy - somac * eps_pred) / sac


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` for self-attention: q, k, v
    projections to (heads, head_dim), queries scaled by 1/sqrt(head_dim),
    softmax in ``dtype``, dropout on the weights with one mask broadcast over
    the batch and the heads (flax's ``broadcast_dropout``)."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float,
                 dtype=torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} is not a multiple of "
                             f"num_heads={num_heads}")
        self.num_heads, self.dropout_rate, self.dtype = (
            num_heads, dropout_rate, dtype)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, *, train: bool, generator):
        B, L, d = x.shape
        H = self.num_heads
        D = d // H

        def heads(lin):
            return dense(x, lin, self.dtype).reshape(B, L, H, D)

        q = heads(self.query) / torch.tensor(math.sqrt(D), dtype=self.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, heads(self.key))
        weights = torch.softmax(logits, dim=-1)
        if train and self.dropout_rate > 0.0:
            weights = dropout(weights, self.dropout_rate, generator,
                              shape=(1, 1, L, L))
        o = torch.einsum("bhqk,bkhd->bqhd", weights, heads(self.value))
        return dense(o.reshape(B, L, d), self.out, self.dtype)


class TransformerEncoderLayer(nn.Module):
    """torch's ``nn.TransformerEncoderLayer`` as the reference configures it
    (post-LN, relu, batch_first, TFD:510-523), with the flax module's dtype
    rules and parameter structure."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float, dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.attn = MultiHeadDotProductAttention(d_model, num_heads,
                                                 dropout_rate, dtype)
        self.norm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dense_0 = nn.Linear(d_model, dim_feedforward)
        self.dense_1 = nn.Linear(dim_feedforward, d_model)
        self.norm_1 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, *, train: bool, generator):
        rate = self.dropout_rate
        attn = self.attn(x, train=train, generator=generator)
        attn = maybe_dropout(attn, rate, train, generator)
        x = layer_norm(x + attn, self.norm_0, self.dtype)
        ff = torch.relu(dense(x, self.dense_0, self.dtype))
        ff = maybe_dropout(ff, rate, train, generator)
        ff = maybe_dropout(dense(ff, self.dense_1, self.dtype), rate, train,
                           generator)
        return layer_norm(x + ff, self.norm_1, self.dtype)


class TransformerDiffusionModel(nn.Module):
    """The reference's ModelOnePassTransformerWithDiffusion (TFD:480-575).

    ``forward(x, generator=, train=False)`` takes (B, n_cases, feat_dim) and
    returns (B, n_elem) float32.
    """

    def __init__(self, n_cases: int = 6, feat_dim: int = 120,
                 n_elem: int = 100, hidden_units: int = 128,
                 num_transformer_layers: int = 2, num_heads: int = 8,
                 dim_feedforward: int = 256, dropout_rate: float = 0.1,
                 max_len: int = 512, diffusion_hidden_dim: int = 256,
                 diffusion_T: int = 512, dtype=torch.float32):
        super().__init__()
        self.n_cases, self.feat_dim, self.n_elem = n_cases, feat_dim, n_elem
        self.num_heads = num_heads
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.diffusion = DiffusionModule(feat_dim, diffusion_hidden_dim,
                                         diffusion_T, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, feat_dim))
        self.register_buffer("pe", torch.from_numpy(
            sincos_positional_encoding(max_len, feat_dim)), persistent=False)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(feat_dim, num_heads, dim_feedforward,
                                    dropout_rate, dtype)
            for _ in range(num_transformer_layers))
        self.dense_0 = nn.Linear(feat_dim, hidden_units)
        self.norm_0 = nn.LayerNorm(hidden_units, eps=LN_EPS)
        self.dense_1 = nn.Linear(hidden_units, n_elem)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from flax's initializers with ``generator``
        (a CPU generator: the draws do not depend on the device)."""
        reset_flax_(self, generator)
        with torch.no_grad():
            self.cls_token.copy_(0.02 * torch.randn(self.cls_token.shape,
                                                    generator=generator))

    def forward(self, x, *, generator, train: bool = False):
        B, Nc, Fd = x.shape
        if (Nc, Fd) != (self.n_cases, self.feat_dim):
            raise ValueError(f"Input dims {tuple(x.shape)} do not match "
                             f"(B, {self.n_cases}, {self.feat_dim}).")
        x = self.diffusion(x.to(self.dtype), generator)
        cls = self.cls_token.to(self.dtype).expand(B, 1, Fd)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pe[: x.shape[1]].to(self.dtype)
        for layer in self.layers:
            x = layer(x, train=train, generator=generator)
        h = dense(x[:, 0, :], self.dense_0, self.dtype)
        h = torch.relu(layer_norm(h, self.norm_0, self.dtype))
        h = maybe_dropout(h, self.dropout_rate, train, generator)
        return dense(h, self.dense_1, torch.float32)
