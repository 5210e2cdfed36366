"""Surrogate-family registry (port of ``families.py``): each reference
training script's model and hyperparameters as one named recipe.

The table is the JAX package's, field for field (plain data).  Provenance
(file:line ranges):

  fnn      OpenPyStruct_FNN_MultiCase.py:35-51
  pinn     OpenPyStruct_PINN_MultiCase.py:34-58
  fno      OpenPyStruct_FNO_MultiCase_Beta.py:36-62
  gnn      OpenPyStruct_GNN_MultiCase_Beta.py:37-55
  tfd      OpenPyStruct_TransformerDiffusionModule_MultiCase.py:36-60
  bnn      OpenPyStruct_Bayesian_TFDModule_MultiCase_Beta.py:36-65
  bnn-meta OpenPyStruct_Bayesian_TFDModule_Meta_MultiCase_Beta.py:36-65

``build_family`` builds all seven with the JAX package's arguments
(families.py:209-241).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from openpystruct_tpu_torch.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    name: str
    train: TrainConfig
    nheads_pad: Optional[int]          # pipeline feature padding
    extra_label_keys: Tuple[str, ...]  # PINN appends deflections/rotations
    model_rng_keys: Tuple[str, ...]
    decoupled_weight_decay: bool       # AdamW (GNN) vs torch Adam-L2
    agg: str = "mean_std"


FAMILIES = {
    "fnn": FamilySpec(
        name="fnn",
        train=TrainConfig(
            n_cases=6, hidden_units=128, dropout_rate=0.5, num_epochs=500,
            batch_size=128, patience=10, learning_rate=2e-4,
            weight_decay=1e-2, sigma_0=0.03, gamma_noise=0.97, lr_gamma=0.99,
            c=1.0, box_constraint_coeff=5e-1,
        ),
        nheads_pad=None, extra_label_keys=(), model_rng_keys=("dropout",),
        decoupled_weight_decay=False,
    ),
    "pinn": FamilySpec(
        name="pinn",
        train=TrainConfig(
            n_cases=6, hidden_units=350, dropout_rate=0.5, num_epochs=500,
            batch_size=128, patience=10, learning_rate=5e-4,
            weight_decay=1e-3, sigma_0=0.01, gamma_noise=0.99, lr_gamma=0.98,
            c=0.5, box_constraint_coeff=1e-1,
        ),
        nheads_pad=None, extra_label_keys=("deflections", "rotations"),
        model_rng_keys=("dropout",), decoupled_weight_decay=False,
    ),
    "fno": FamilySpec(
        name="fno",
        train=TrainConfig(
            n_cases=6, hidden_units=512, dropout_rate=0.1, num_epochs=500,
            batch_size=512, patience=10, learning_rate=3e-3,
            weight_decay=1e-6, sigma_0=0.01, gamma_noise=0.95,
            lr_gamma=0.975, c=0.5, box_constraint_coeff=5e-1,
            # The reference disables AMP for the FNO — the spectral path is
            # precision-sensitive (OpenPyStruct_FNO_MultiCase_Beta.py:576-578,
            # 617-618); every other family autocasts
            # (OpenPyStruct_FNN_MultiCase.py:490,543-554).
            compute_dtype="float32",
        ),
        nheads_pad=None, extra_label_keys=(), model_rng_keys=("dropout",),
        decoupled_weight_decay=False,
    ),
    "gnn": FamilySpec(
        name="gnn",
        train=TrainConfig(
            n_cases=6, hidden_units=128, dropout_rate=0.5, num_epochs=500,
            batch_size=512, patience=10, learning_rate=3e-3,
            weight_decay=1e-2, sigma_0=0.01, gamma_noise=0.99,
            lr_gamma=0.975, c=0.5, box_constraint_coeff=5e-1,
        ),
        nheads_pad=None, extra_label_keys=(), model_rng_keys=("dropout",),
        decoupled_weight_decay=True,
    ),
    "tfd": FamilySpec(
        name="tfd",
        train=TrainConfig(
            n_cases=6, hidden_units=256, dropout_rate=0.1, num_epochs=500,
            batch_size=512, patience=10, learning_rate=3e-3,
            weight_decay=1e-4, sigma_0=0.01, gamma_noise=0.90,
            lr_gamma=0.95, c=0.5, box_constraint_coeff=5e-1,
        ),
        nheads_pad=8, extra_label_keys=(),
        model_rng_keys=("dropout", "diffusion"),
        decoupled_weight_decay=False,
    ),
    "bnn": FamilySpec(
        name="bnn",
        train=TrainConfig(
            n_cases=6, hidden_units=512, dropout_rate=0.1, num_epochs=500,
            batch_size=512, patience=10, learning_rate=3e-4,
            weight_decay=1e-6, sigma_0=0.01, gamma_noise=0.95,
            lr_gamma=0.99, c=0.5, box_constraint_coeff=5e-1,
        ),
        nheads_pad=24, extra_label_keys=(),
        model_rng_keys=("dropout", "diffusion", "bayes"),
        decoupled_weight_decay=False,
    ),
    "bnn-meta": FamilySpec(
        name="bnn-meta",
        train=TrainConfig(
            n_cases=8, hidden_units=512, dropout_rate=0.01, num_epochs=500,
            batch_size=512, patience=10, learning_rate=3e-4,
            weight_decay=1e-6, sigma_0=0.01, gamma_noise=0.95,
            lr_gamma=0.99, c=1.0, box_constraint_coeff=5e-1,
        ),
        nheads_pad=24, extra_label_keys=(),
        model_rng_keys=("dropout", "diffusion", "bayes"),
        decoupled_weight_decay=False,
    ),
}

BNN_KL_SCALE = 1e-6      # OpenPyStruct_Bayesian_TFDModule_MultiCase_Beta.py:57
PINN_PENALTY = 1.5e-6    # OpenPyStruct_PINN_MultiCase.py:58


#: ``TrainConfig.compute_dtype`` values -> model compute dtypes (the analog
#: of the reference's CUDA AMP autocast, OpenPyStruct_FNN_MultiCase.py:
#: 490,543-554: matmuls and activations run in the low-precision dtype,
#: LayerNorms and output heads stay float32, per the models' ``dtype``).
COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def build_family(name: str, feat_dim: int, nelem: int = 100,
                 label_dim: Optional[int] = None,
                 compute_dtype: Optional[str] = None):
    """Instantiate (model, spec, fit_kwargs) for a family.

    ``feat_dim`` is the (padded) per-case feature width from the pipeline;
    ``label_dim`` the full label width (the PINN's nelem + 2 (nelem + 1)).
    ``compute_dtype`` overrides the family's ``TrainConfig.compute_dtype``
    (bfloat16 everywhere but the FNO, which the reference exempts from AMP
    and stays pinned float32, OpenPyStruct_FNO_MultiCase_Beta.py:617-618).
    The model is built on the CPU; ``train.fit`` moves it to its device.
    ``fit_kwargs`` holds what ``fit`` needs beyond the data: the PINN's
    ``loss_fn_builder``, the GNN's ``decoupled_weight_decay`` (AdamW), the
    Bayesian TFDs' ``param_loss_fn`` (``BNN_KL_SCALE * bayes_kl``); the
    other families need nothing (eval-time diffusion and "bayes" draws come
    from the generator every forward takes).
    """
    if name not in FAMILIES:
        raise ValueError(f"unknown family {name!r}; options: {list(FAMILIES)}")
    spec = FAMILIES[name]
    cfg = spec.train
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        spec = dataclasses.replace(spec, train=cfg)
    if name == "fno" and cfg.compute_dtype != "float32":
        # precision-sensitive spectral path: the reference's AMP exception
        # (OpenPyStruct_FNO_MultiCase_Beta.py:576-578,617-618)
        raise ValueError("the FNO family is pinned float32")
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    label_dim = label_dim or nelem
    fit_kwargs = {}
    from openpystruct_tpu_torch.models import (
        BayesianTransformerDiffusionModel,
        ChainGNN,
        FNNWithResidual,
        FNO1dModel,
        PINNWithResidual,
        TransformerDiffusionModel,
        bayes_kl,
        composite_pinn_loss,
    )

    if name == "fnn":
        model = FNNWithResidual(
            input_dim=cfg.n_cases * feat_dim, hidden_dim=cfg.hidden_units,
            num_blocks=4, output_dim=label_dim,
            dropout_rate=cfg.dropout_rate, dtype=dtype,
        )
    elif name == "pinn":
        model = PINNWithResidual(
            input_dim=cfg.n_cases * feat_dim, hidden_dim=cfg.hidden_units,
            num_blocks=2, output_dim=label_dim,
            dropout_rate=cfg.dropout_rate, dtype=dtype,
        )

        def pinn_loss_builder(Y_train):
            # box bounds at the min and max of the STANDARDIZED train
            # labels' I slice (OpenPyStruct_PINN_MultiCase.py:377-378,
            # applied at 556-558,588-597), on the device; one process
            min_c, max_c = Y_train[:, :nelem].min(), Y_train[:, :nelem].max()

            def pinn_loss(alpha, preds, targets):
                return composite_pinn_loss(
                    alpha, preds, targets, nelem=nelem,
                    min_constraint=min_c, max_constraint=max_c,
                    box_constraint_coeff=cfg.box_constraint_coeff,
                    penalty_pinn=PINN_PENALTY,
                )

            return pinn_loss

        fit_kwargs["loss_fn_builder"] = pinn_loss_builder
    elif name == "fno":
        model = FNO1dModel(
            n_cases=cfg.n_cases, feat_dim=feat_dim, n_elem=label_dim,
            fno_modes=4, fno_width=128, num_fno_layers=4,
            hidden_units=cfg.hidden_units, dropout_rate=cfg.dropout_rate,
        )
    elif name == "gnn":
        model = ChainGNN(
            input_dim=cfg.n_cases * feat_dim, n_elem=label_dim,
            encoder_hidden_dim=128, gnn_hidden_dim=128, num_gnn_layers=2,
            dropout_rate=cfg.dropout_rate, dtype=dtype,
        )
        fit_kwargs["decoupled_weight_decay"] = spec.decoupled_weight_decay
    elif name in ("bnn", "bnn-meta"):
        model = BayesianTransformerDiffusionModel(
            n_cases=cfg.n_cases, feat_dim=feat_dim, n_elem=label_dim,
            hidden_units=cfg.hidden_units, num_transformer_layers=4,
            num_heads=24, dim_feedforward=512,
            dropout_rate=cfg.dropout_rate, diffusion_hidden_dim=512,
            use_output_scales=(name == "bnn-meta"), dtype=dtype,
        )
        fit_kwargs["param_loss_fn"] = lambda p: BNN_KL_SCALE * bayes_kl(p)
    else:
        model = TransformerDiffusionModel(
            n_cases=cfg.n_cases, feat_dim=feat_dim, n_elem=label_dim,
            hidden_units=cfg.hidden_units, num_transformer_layers=2,
            num_heads=8, dim_feedforward=256,
            dropout_rate=cfg.dropout_rate, diffusion_hidden_dim=256,
            dtype=dtype,
        )
    return model, spec, fit_kwargs
