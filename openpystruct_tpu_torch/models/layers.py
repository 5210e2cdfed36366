"""flax.linen's layer rules in PyTorch, shared by the port's surrogates.

Precision follows a flax module's ``dtype`` field, not a global autocast:
parameters are float32 and cast to ``dtype`` where a dense layer uses them;
LayerNorm and BatchNorm compute in float32 (flax's epsilons, 1e-6 and 1e-5,
not torch's) and cast back.  Parameters start from flax's initializers:
lecun-normal kernels (a normal truncated at 2 sigma, variance 1 / fan_in),
zero biases, unit norm scales (``reset_flax_``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6   # flax.linen.LayerNorm's default (torch's is 1e-5)
BN_EPS = 1e-5   # flax.linen.BatchNorm's default


def dense(x, lin: nn.Linear, dtype):
    """flax ``Dense(dtype=dtype)``: input and float32 parameters cast to
    ``dtype`` (``use_bias=False`` is a Linear without bias)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(x, ln: nn.LayerNorm, dtype):
    """flax ``LayerNorm(dtype=float32)(x).astype(dtype)``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(dtype)


def leaky_relu(x, negative_slope: float = 0.01):
    """flax ``nn.leaky_relu(x, negative_slope)``; the FNO's head and the
    Bayesian MLPs pass 0.1."""
    return F.leaky_relu(x, negative_slope)


def dropout(x, rate: float, generator, shape=None):
    """flax ``Dropout``: keep with probability 1 - rate, kept values divided
    by it; ``shape`` broadcasts one mask over the dimensions of size 1."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def maybe_dropout(x, rate: float, train: bool, generator):
    """``dropout`` in training with a rate above 0, else ``x``."""
    if train and rate > 0.0:
        return dropout(x, rate, generator)
    return x


def lecun_normal_(w: torch.Tensor, fan_in: int, generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                      -2.0 * std, 2.0 * std,
                                      generator=generator))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, dtype=float32)`` over the last
    axis: statistics in float32 over every other axis, the fast variance
    E[x^2] - E[x]^2 clipped at 0 (biased), y = (x - mean) * scale /
    sqrt(var + 1e-5) + bias.  In training the running statistics become
    0.9 * running + 0.1 * batch, the biased variance included; otherwise
    they are what normalizes.  They are the buffers ``running_mean`` and
    ``running_var`` (flax's ``batch_stats`` mean and var), not
    ``nn.BatchNorm1d``'s, whose update blends the unbiased variance with
    momentum 0.1 on the other side."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, *, train: bool):
        x = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def reset_flax_(module: nn.Module, generator: torch.Generator):
    """Draw every Linear and Conv1d of ``module`` from flax's initializers
    with ``generator`` (a CPU generator: the draws do not depend on the
    device), in module order; unit scales and zero biases for the norms,
    fresh running statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
