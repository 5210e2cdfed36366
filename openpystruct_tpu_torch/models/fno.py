"""Fourier Neural Operator surrogate over the load-case axis (port of
``models/fno.py``).

Reference: ``SpectralConv1d`` + ``FNOBlock1d`` + ``FNO1dModel``
(OpenPyStruct_FNO_MultiCase_Beta.py:340-495): lift feat_dim -> width with a
pointwise Dense, 4 blocks of [spectral conv + pointwise conv + BatchNorm +
GELU] along the n_cases axis, then flatten -> Dropout -> Dense ->
LeakyReLU(0.1) -> Dropout -> Dense -> n_elem.

All of it runs in float32 (the reference disables AMP for this family,
OpenPyStruct_FNO_MultiCase_Beta.py:617-618); its matmuls need TF32 off,
which is torch's default.  The spectral conv is the JAX package's real-DFT
matmul form: rfft -> truncate to ``modes`` bins -> mix -> zero-pad ->
irfft as cos/sin matrices (``_dft_mats``, a copy of the JAX module's
numpy), so the DC and Nyquist bins' imaginary parts are ignored as
numpy's c2r transform ignores them, on any device (cuFFT's C2R does not
document that for input that is not Hermitian).  ``degenerate_mixing``
keeps the reference's broadcast-sum quirk (see the JAX module).  GELU is
flax's default, the tanh approximation; the BatchNorm is flax's over axis
1 of (B, width, n), momentum 0.9 (``layers.BatchNorm`` on the transposed
tensor).  Submodule names follow the flax tree
(``interop.fno_params_from_flax``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    BatchNorm,
    dense,
    leaky_relu,
    maybe_dropout,
    reset_flax_,
)


def _dft_mats(n: int, modes: int):
    """Real-DFT analysis/synthesis matrices for the truncated spectrum
    (numpy float64): Xr = x @ cosF, Xi = -(x @ sinF); y = Xr @ A + Xi @ B
    with the Hermitian weights c_m (1 at DC and Nyquist, 2 elsewhere)
    folded in and B's DC/Nyquist rows zero."""
    k = np.arange(n)[:, None]
    m = np.arange(modes)[None, :]
    ang = 2.0 * np.pi * k * m / n
    cosF = np.cos(ang)                     # (n, modes)
    sinF = np.sin(ang)
    c = np.full(modes, 2.0)
    c[0] = 1.0
    if n % 2 == 0 and modes - 1 == n // 2:
        c[n // 2] = 1.0
    A = (c * cosF).T / n                   # (modes, n)
    B = -(c * sinF).T / n                  # minus: y = Xr cos - Xi sin
    return cosF, sinF, A, B


@functools.lru_cache(maxsize=32)
def _dft_tensors(n: int, modes: int, device: torch.device):
    """``_dft_mats`` as float32 tensors on ``device``, built once."""
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in _dft_mats(n, modes))


class SpectralConv1d(nn.Module):
    """x: (B, in_channels, n) -> (B, out_channels, n), float32.  Weights
    ``weights_real``/``weights_imag`` (in, out, modes), U(0, 1 / (in out))
    at the start (OpenPyStruct_FNO_MultiCase_Beta.py:349-356)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 degenerate_mixing: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes, self.degenerate_mixing = modes, degenerate_mixing
        shape = (in_channels, out_channels, modes)
        self.weights_real = nn.Parameter(torch.zeros(shape))
        self.weights_imag = nn.Parameter(torch.zeros(shape))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        scale = 1.0 / (self.in_channels * self.out_channels)
        with torch.no_grad():
            for w in (self.weights_real, self.weights_imag):
                w.copy_(scale * torch.rand(w.shape, generator=generator))

    def forward(self, x):
        x = x.float()
        n = x.shape[-1]
        modes = min(self.modes, n // 2 + 1)
        cosF, sinF, inv_c, inv_s = _dft_tensors(n, modes, x.device)
        xr = torch.einsum("bin,nm->bim", x, cosF)
        xi = -torch.einsum("bin,nm->bim", x, sinF)
        w_r = self.weights_real[:, :, :modes]
        w_i = self.weights_imag[:, :, :modes]
        if self.degenerate_mixing:
            sr, si = xr.sum(1), xi.sum(1)            # (B, modes)
            vr, vi = w_r.sum(1), w_i.sum(1)          # (O, modes)
            out_r = sr[:, None, :] * vr[None] - si[:, None, :] * vi[None]
            out_i = sr[:, None, :] * vi[None] + si[:, None, :] * vr[None]
        else:
            out_r = (torch.einsum("bim,iom->bom", xr, w_r)
                     - torch.einsum("bim,iom->bom", xi, w_i))
            out_i = (torch.einsum("bim,iom->bom", xr, w_i)
                     + torch.einsum("bim,iom->bom", xi, w_r))
        return (torch.einsum("bom,mn->bon", out_r, inv_c)
                + torch.einsum("bom,mn->bon", out_i, inv_s))


class FNOBlock1d(nn.Module):
    """Spectral conv + pointwise conv (a Dense over the channel axis) ->
    BatchNorm over (B, n) per channel -> GELU (tanh); x: (B, width, n)."""

    def __init__(self, width: int, modes: int,
                 degenerate_mixing: bool = False):
        super().__init__()
        self.spectral = SpectralConv1d(width, width, modes,
                                       degenerate_mixing=degenerate_mixing)
        self.dense_0 = nn.Linear(width, width)
        self.norm_0 = BatchNorm(width)

    def forward(self, x, *, train: bool):
        x2 = dense(x.transpose(1, 2), self.dense_0, torch.float32)
        out = self.spectral(x) + x2.transpose(1, 2)
        out = self.norm_0(out.transpose(1, 2), train=train).transpose(1, 2)
        return F.gelu(out, approximate="tanh")


class FNO1dModel(nn.Module):
    """``forward(x, generator=, train=False)`` takes (B, n_cases, feat_dim)
    and returns (B, n_elem) float32."""

    def __init__(self, n_cases: int = 6, feat_dim: int = 20,
                 n_elem: int = 100, fno_modes: int = 4, fno_width: int = 128,
                 num_fno_layers: int = 4, hidden_units: int = 512,
                 dropout_rate: float = 0.1, degenerate_mixing: bool = False):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, torch.float32
        self.dense_0 = nn.Linear(feat_dim, fno_width)
        self.blocks = nn.ModuleList(
            FNOBlock1d(fno_width, fno_modes, degenerate_mixing)
            for _ in range(num_fno_layers))
        self.dense_1 = nn.Linear(fno_width * n_cases, hidden_units)
        self.dense_2 = nn.Linear(hidden_units, n_elem)
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        reset_flax_(self, generator)
        for block in self.blocks:
            block.spectral.reset_parameters(generator)

    def forward(self, x, *, generator, train: bool = False):
        f32 = torch.float32
        # lift: feat_dim -> width (OpenPyStruct_FNO_MultiCase_Beta.py:475-478)
        x = dense(x, self.dense_0, f32).transpose(1, 2)   # (B, width, Nc)
        for block in self.blocks:
            x = block(x, train=train)
        x = maybe_dropout(x.reshape(x.shape[0], -1), self.dropout_rate,
                          train, generator)
        x = leaky_relu(dense(x, self.dense_1, f32), 0.1)
        x = maybe_dropout(x, self.dropout_rate, train, generator)
        return dense(x, self.dense_2, f32)
