"""Port: ``fit``'s checkpoint and resume (``fit(checkpoint_dir=,
resume_from=, checkpoint_every=)``), the two cases of tests/test_resume.py
held bitwise instead of to 1e-6, and every family's carried state.

- A run killed at a sync boundary and resumed equals the uninterrupted run
  bitwise: train and val losses, best epoch, stop flag, the best and the
  final parameters (BatchNorm buffers and alpha among them), for either
  ``epochs_per_sync`` on the resumed side.
- The checkpoint holds the optimizer's moments (non-zero after training)
  and the epoch reached.
- The GNN (AdamW state), ``bnn`` (its "bayes" draws from the (seed, epoch)
  stream, its KL term through ``param_loss_fn``) and the PINN (BatchNorm
  running statistics) resume bitwise too, and the checkpoint's seed wins
  over the one passed on resume.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from openpystruct_tpu_torch import families as tfam
from openpystruct_tpu_torch.config import TrainConfig
from openpystruct_tpu_torch.models import ChainGNN, FNNWithResidual
from openpystruct_tpu_torch.models import bayesian as tbayes
from openpystruct_tpu_torch.train import fit, load_checkpoint
from openpystruct_tpu_torch.train.harness import STATE_FILE


@pytest.fixture(autouse=True)
def _one_thread():
    """These models are small: one intra-op thread runs them several times
    faster than many, above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, B=64, n_cases=4, feat=12, nelem=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n_cases, feat)).astype(np.float32)
    Y = rng.normal(size=(B, nelem)).astype(np.float32)
    Xv = rng.normal(size=(16, n_cases, feat)).astype(np.float32)
    Yv = rng.normal(size=(16, nelem)).astype(np.float32)
    return X, Y, Xv, Yv


def _fnn(nelem=10):
    return FNNWithResidual(4 * 12, hidden_dim=16, num_blocks=1,
                           output_dim=nelem, dropout_rate=0.1,
                           dtype=torch.float32)


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert (a.best_epoch, a.stopped_early) == (b.best_epoch, b.stopped_early)
    assert a.state["step"] == b.state["step"]
    for pa, pb in ((a.params, b.params),
                   (a.state["params"], b.state["params"])):
        assert pa["model"].keys() == pb["model"].keys()
        for k in pa["model"]:
            assert torch.equal(pa["model"][k], pb["model"][k]), k
        assert torch.equal(pa["alpha"], pb["alpha"])


@pytest.mark.parametrize("resumed_sync", [2, 3])
def test_kill_and_resume_reproduces_trajectory(tmp_path, resumed_sync):
    X, Y, Xv, Yv = _data()
    cfg = TrainConfig(num_epochs=8, batch_size=16, patience=50,
                      hidden_units=16)
    ckpt = str(tmp_path / "state")

    # uninterrupted reference run
    full = fit(_fnn(), X, Y, Xv, Yv, cfg, seed=7, epochs_per_sync=2,
               device="cpu")

    # "killed" run: stop after 4 epochs, checkpointing every chunk
    half = dataclasses.replace(cfg, num_epochs=4)
    part = fit(_fnn(), X, Y, Xv, Yv, half, seed=7, epochs_per_sync=2,
               checkpoint_dir=ckpt, device="cpu")
    np.testing.assert_array_equal(part.val_losses, full.val_losses[:4])

    # resume to the full budget
    resumed = fit(_fnn(), X, Y, Xv, Yv, cfg, seed=7,
                  epochs_per_sync=resumed_sync, resume_from=ckpt,
                  device="cpu")
    assert len(resumed.val_losses) == 8
    _assert_same_run(resumed, full)


def test_resume_restores_optimizer_state(tmp_path):
    # a fresh-optimizer restart would diverge at once; check the saved Adam
    # moments are non-trivial (not zero-initialized) and the epoch reached
    X, Y, Xv, Yv = _data(seed=1)
    cfg = TrainConfig(num_epochs=2, batch_size=16, patience=50,
                      hidden_units=16)
    ckpt = str(tmp_path / "state")
    fit(_fnn(), X, Y, Xv, Yv, cfg, seed=0, epochs_per_sync=1,
        checkpoint_dir=ckpt, device="cpu")

    raw = load_checkpoint(os.path.join(ckpt, STATE_FILE))
    moments = [v for st in raw["optimizer"]["state"].values()
               for k, v in st.items() if k.startswith("exp_avg")]
    assert moments and any(float(m.abs().max()) > 0 for m in moments)
    assert raw["epoch0"] == 2 and len(raw["val_hist"]) == 2
    assert raw["count"] == 2 * (64 // 16)


N_CASES, FEAT, NELEM = 6, 5, 7


def _family(name):
    """(model factory, data, TrainConfig, fit kwargs) of a small member of
    the family ``name``."""
    rng = np.random.default_rng(2)
    if name == "bnn":
        n_cases, feat, label = 3, 8, 5
    elif name == "pinn":
        n_cases, feat, label = 6, 8, 302
    else:
        n_cases, feat, label = N_CASES, FEAT, NELEM
    W = rng.normal(size=(n_cases * feat, label)) / np.sqrt(n_cases * feat)

    def split(n):
        X = rng.normal(size=(n, n_cases, feat)).astype(np.float32)
        return X, (X.reshape(n, -1) @ W).astype(np.float32)

    data = (*split(24), *split(9))
    if name == "gnn":
        _, spec, kw = tfam.build_family("gnn", FEAT)

        def make():
            return ChainGNN(N_CASES * FEAT, n_elem=NELEM,
                            encoder_hidden_dim=12, gnn_hidden_dim=8,
                            num_gnn_layers=2, dropout_rate=0.5,
                            dtype=torch.float32)
    elif name == "bnn":
        _, spec, kw = tfam.build_family("bnn", 24)

        def make():
            return tbayes.BayesianTransformerDiffusionModel(
                dtype=torch.float32, use_output_scales=False,
                dropout_rate=0.1, n_cases=3, feat_dim=8, n_elem=5,
                hidden_units=12, num_transformer_layers=2, num_heads=4,
                dim_feedforward=12, diffusion_hidden_dim=10)
    else:
        _, spec, kw = tfam.build_family("pinn", 8, label_dim=label,
                                        compute_dtype="float32")

        def make():
            return tfam.build_family("pinn", 8, label_dim=label,
                                     compute_dtype="float32")[0]
    cfg = dataclasses.replace(spec.train, num_epochs=6, batch_size=8,
                              learning_rate=3e-3)
    return make, data, cfg, kw


@pytest.mark.parametrize("name", ["gnn", "bnn", "pinn"])
def test_family_resume_bitwise(tmp_path, name):
    make, data, cfg, kw = _family(name)
    full = fit(make(), *data, cfg, seed=3, epochs_per_sync=2, device="cpu",
               **kw)
    ckpt = str(tmp_path / name)
    fit(make(), *data, dataclasses.replace(cfg, num_epochs=3), seed=3,
        epochs_per_sync=2, checkpoint_dir=ckpt, checkpoint_every=5,
        device="cpu", **kw)
    # the checkpoint's seed wins: the seed passed on resume is ignored
    resumed = fit(make(), *data, cfg, seed=99, epochs_per_sync=2,
                  resume_from=ckpt, device="cpu", **kw)
    _assert_same_run(resumed, full)
    if name == "gnn":
        raw = load_checkpoint(os.path.join(ckpt, STATE_FILE))
        assert raw["optimizer"]["param_groups"][0]["weight_decay"] > 0
    if name == "pinn":
        assert any("running_" in k for k in full.params["model"])
