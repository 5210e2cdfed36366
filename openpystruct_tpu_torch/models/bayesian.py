"""Bayesian Transformer-Diffusion surrogates (port of
``models/bayesian.py``).

Reference: ``BayesianDiffusionMLP`` + ``BayesianOutputMLP`` built on
``torchbnn.BayesLinear(prior_mu=0, prior_sigma=0.01)`` around the TFD's
transformer trunk (OpenPyStruct_Bayesian_TFDModule_MultiCase_Beta.py:
392-580, 4 layers / 24 heads / ff 512), the KL summed over the Bayesian
layers and scaled by ``bnn_kl_scale=1e-6`` into the train and val losses
(BNN:706-709,729-730; ``fit(param_loss_fn=)``).  The Meta variant
(``use_output_scales=True``) adds a trainable per-element output multiplier
(Meta:551-555,587-592) and Monte-Carlo mean/std uncertainty over
stochastic forwards (``mc_output_stats``, Meta:806-824).  As in the JAX
package the KL is the analytic Gaussian one, summed over kernels and
biases: the reference's own sum is silently empty (see the JAX module).

``BayesLinear`` keeps flax's parameter layout: ``mu_kernel`` and
``log_sigma_kernel`` (in, out), ``mu_bias`` and ``log_sigma_bias`` (out,),
mu ~ U(-1/sqrt(in), 1/sqrt(in)), log sigma = log 0.01 at the start.  Every
forward samples w = mu + exp(log sigma) eps, eps drawn in ``dtype`` from
the generator the forward takes (kernel first, then bias), as are the
diffusion step's t and epsilon; torch draws, not ``jax.random``.

Precision follows JAX's type promotion, not the TFD's casts: in bfloat16
the product x @ w is bfloat16 and the float32 sampled bias makes it
float32, so every ``BayesLinear``, the diffusion module and the residual
stream up to the first LayerNorm are float32 (the class token is cast to
bfloat16 and promoted back by the concatenation; the positional table is
bfloat16).  In bfloat16 the diffusion step is an exact identity, as in
the TFD.  Submodule names follow the flax tree
(``interop.bnn_params_from_flax``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from openpystruct_tpu_torch.models.layers import (
    LN_EPS,
    layer_norm,
    leaky_relu,
    maybe_dropout,
    reset_flax_,
)
from openpystruct_tpu_torch.models.transformer_diffusion import (
    TransformerEncoderLayer,
    diffusion_noise,
    sincos_positional_encoding,
)

PRIOR_MU = 0.0
PRIOR_SIGMA = 0.01


def _normal(shape, generator, device, dtype):
    """The standard normal draws of a ``BayesLinear`` and the diffusion
    epsilon."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype)


def _randint(high, shape, generator, device):
    """The diffusion step t per (B, case)."""
    return torch.randint(0, high, shape, generator=generator, device=device)


class BayesLinear(nn.Module):
    """Variational linear layer: w ~ N(mu, exp(log_sigma)^2), sampled on
    every forward."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mu_kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.log_sigma_kernel = nn.Parameter(
            torch.zeros(in_features, out_features))
        self.mu_bias = nn.Parameter(torch.zeros(out_features))
        self.log_sigma_bias = nn.Parameter(torch.zeros(out_features))

    def reset_parameters(self, generator: torch.Generator):
        k = 1.0 / math.sqrt(self.mu_kernel.shape[0])
        with torch.no_grad():
            for mu in (self.mu_kernel, self.mu_bias):
                mu.copy_(torch.rand(mu.shape, generator=generator) * (2 * k)
                         - k)
            for ls in (self.log_sigma_kernel, self.log_sigma_bias):
                ls.fill_(math.log(PRIOR_SIGMA))

    def forward(self, x, generator):
        w = self.mu_kernel + torch.exp(self.log_sigma_kernel) * _normal(
            self.mu_kernel.shape, generator, x.device, self.dtype)
        b = self.mu_bias + torch.exp(self.log_sigma_bias) * _normal(
            self.mu_bias.shape, generator, x.device, self.dtype)
        return x.to(self.dtype) @ w.to(self.dtype) + b


def bayes_kl(params, prior_mu: float = PRIOR_MU,
             prior_sigma: float = PRIOR_SIGMA):
    """Analytic Gaussian KL(N(mu, s^2) || N(m0, s0^2)) = log(s0 / s) + (s^2
    + (mu - m0)^2) / (2 s0^2) - 1/2, summed over every ``BayesLinear``'s
    kernel and bias in ``params`` (parameters by name, as ``fit`` passes
    them to ``param_loss_fn``)."""
    total = 0.0
    for name in params:
        if not name.endswith("mu_kernel"):
            continue
        prefix = name[:-len("mu_kernel")]
        for mu_k, ls_k in (("mu_kernel", "log_sigma_kernel"),
                           ("mu_bias", "log_sigma_bias")):
            mu, ls = params[prefix + mu_k], params[prefix + ls_k]
            total = total + torch.sum(
                math.log(prior_sigma) - ls
                + (torch.exp(2.0 * ls) + (mu - prior_mu) ** 2)
                / (2.0 * prior_sigma ** 2) - 0.5)
    return total


class BayesianMLP(nn.Module):
    """BayesLinear -> LayerNorm (float32, cast back) -> LeakyReLU(0.1) ->
    Dropout -> BayesLinear: the reference's ``BayesianDiffusionMLP``
    (BNN:392-421) and ``BayesianOutputMLP`` (BNN:473-501), one body."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout_rate: float, dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.bayes_0 = BayesLinear(in_dim, hidden_dim, dtype=dtype)
        self.norm_0 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.bayes_1 = BayesLinear(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x, *, generator, train: bool):
        x = layer_norm(self.bayes_0(x, generator), self.norm_0, self.dtype)
        x = maybe_dropout(leaky_relu(x, 0.1), self.dropout_rate, train,
                          generator)
        return self.bayes_1(x, generator)


BayesianDiffusionMLP = BayesianMLP
BayesianOutputMLP = BayesianMLP


class BayesianDiffusionModule(nn.Module):
    """The TFD's noise/denoise pass with a Bayesian epsilon-predictor
    (BNN:424-470): random t per (B, case), ``diffusion_noise``, then
    (x_noisy - sqrt(1 - ac_t) eps_pred) / sqrt(ac_t)."""

    def __init__(self, feat_dim: int, hidden_dim: int = 512, T: int = 512,
                 beta_start: float = 1e-12, beta_end: float = 1e-5,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.T, self.beta_start, self.beta_end = T, beta_start, beta_end
        self.mlp = BayesianDiffusionMLP(feat_dim, hidden_dim, feat_dim,
                                        dropout_rate, dtype)

    def forward(self, x, *, generator, train: bool):
        t = _randint(self.T, x.shape[:2], generator, x.device)
        eps = _normal(x.shape, generator, x.device, x.dtype)
        x_noisy, sac, somac = diffusion_noise(x, t, eps, self.T,
                                              self.beta_start, self.beta_end)
        eps_pred = self.mlp(x_noisy, generator=generator, train=train)
        return (x_noisy - somac * eps_pred) / sac


class BayesianTransformerDiffusionModel(nn.Module):
    """The Bayesian TFD (BNN:503-580); ``use_output_scales=True`` is the
    Meta variant (its script also uses n_cases 8, dropout 0.01, c 1).
    ``forward(x, generator=, train=False)`` takes (B, n_cases, feat_dim)
    and returns (B, n_elem) float32."""

    def __init__(self, n_cases: int = 6, feat_dim: int = 120,
                 n_elem: int = 100, hidden_units: int = 512,
                 num_transformer_layers: int = 4, num_heads: int = 24,
                 dim_feedforward: int = 512, dropout_rate: float = 0.1,
                 max_len: int = 512, diffusion_hidden_dim: int = 512,
                 diffusion_T: int = 512, use_output_scales: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.n_cases, self.feat_dim, self.n_elem = n_cases, feat_dim, n_elem
        self.num_heads, self.dropout_rate, self.dtype = (
            num_heads, dropout_rate, dtype)
        self.use_output_scales = use_output_scales
        self.diffusion = BayesianDiffusionModule(
            feat_dim, diffusion_hidden_dim, diffusion_T,
            dropout_rate=dropout_rate, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, feat_dim))
        self.register_buffer("pe", torch.from_numpy(
            sincos_positional_encoding(max_len, feat_dim)), persistent=False)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(feat_dim, num_heads, dim_feedforward,
                                    dropout_rate, dtype)
            for _ in range(num_transformer_layers))
        self.head = BayesianOutputMLP(feat_dim, hidden_units, n_elem,
                                      dropout_rate, dtype)
        if use_output_scales:
            self.output_scales = nn.Parameter(torch.ones(n_elem))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator):
        """flax's initializers for the trunk, U(-1/sqrt(in), 1/sqrt(in))
        means and log 0.01 for the Bayesian layers, a zero class token and
        unit output scales, drawn with ``generator`` (a CPU generator)."""
        reset_flax_(self, generator)
        for m in self.modules():
            if isinstance(m, BayesLinear):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.cls_token.zero_()
            if self.use_output_scales:
                self.output_scales.fill_(1.0)

    def forward(self, x, *, generator, train: bool = False):
        B, Nc, Fd = x.shape
        if (Nc, Fd) != (self.n_cases, self.feat_dim):
            raise ValueError(f"Input dims {tuple(x.shape)} do not match "
                             f"(B, {self.n_cases}, {self.feat_dim}).")
        x = self.diffusion(x.to(self.dtype), generator=generator,
                           train=train)
        cls = self.cls_token.to(self.dtype).expand(B, 1, Fd)
        x = torch.cat([cls, x], dim=1)     # promotes as jnp.concatenate
        x = x + self.pe[: x.shape[1]].to(self.dtype)
        for layer in self.layers:
            x = layer(x, train=train, generator=generator)
        out = self.head(x[:, 0, :], generator=generator, train=train)
        if self.use_output_scales:
            out = out * self.output_scales
        return out.float()


def mc_output_stats(model, params, x, n_samples: int = 50, seed: int = 0,
                    scaler_Y=None, device="cuda"):
    """Monte-Carlo predictive mean and population std (ddof 0) over
    ``n_samples`` stochastic forwards at ``train=False`` with ``params``
    (``FitResult.params``): the Meta script's ``get_bnn_output_stats``
    (Meta:806-824, 50 samples at Meta:864).  Sample i draws from a
    generator seeded from (seed, i).  With ``scaler_Y`` the mean is
    un-standardized and the std multiplied by ``scaler_Y.scale``
    (Meta:864-868).  Returns (mean, std), float32 tensors (B, n_elem) on
    ``device``."""
    from torch.func import functional_call

    from openpystruct_tpu_torch.device import resolve_device
    from openpystruct_tpu_torch.train.harness import _generator, _unscale

    device = resolve_device(device)
    model.to(device)
    state = {k: v.to(device) for k, v in params["model"].items()}
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    with torch.no_grad():
        preds = torch.stack([
            functional_call(model, state, (x,), dict(
                generator=_generator(device, seed, i), train=False))
            for i in range(n_samples)])
    mean, std = preds.mean(0), preds.std(0, correction=0)
    if scaler_Y is not None:
        mean = _unscale(mean, scaler_Y)
        std = std * torch.as_tensor(scaler_Y.scale, dtype=std.dtype,
                                    device=device)
    return mean, std
