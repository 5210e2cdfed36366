"""The surrogate-training harness on one device (port of ``train/harness.py``).

Reference pattern reproduced (OpenPyStruct_FNN_MultiCase.py:480-632):
shuffled batches -> per-epoch decaying Gaussian input noise
(sigma_0 * gamma_noise^epoch, epochs counted from 1) -> the model's forward
in its compute dtype -> TrainableL1L2 loss + (alpha_0 - alpha)^2 regularizer
-> global-norm gradient clip 1.0 (optax's rule) -> Adam with L2 weight decay
(torch style: decay added to the gradient before the Adam update;
``decoupled_weight_decay=True`` gives the GNN script's AdamW) -> per-epoch
exponential learning-rate decay -> early stopping on the val loss with
best-params retention -> R^2 on un-standardized, clipped predictions.

As in the JAX package: the whole train set is shuffled every epoch and the
partial trailing train batch is dropped; the val set is evaluated in full,
its ragged remainder as one extra batch; alpha is trained unless
``train_alpha=False`` (models/losses.py says why the reference never
updates it).  The in-batch re-shuffle of the reference
(OpenPyStruct_FNN_MultiCase.py:440-461) is a no-op for these mean losses and
is not reproduced.

Host syncs: one per ``epochs_per_sync`` epochs.  Losses, the best val loss,
the early-stop counter and flag stay on the device between syncs; the
best params and the final state are selected there with ``torch.where``.
Every epoch's shuffle, noise, dropout and diffusion draws come from one
``torch.Generator`` seeded from (seed, epoch), never chained through
chunks, so histories, best params and the final state are bitwise the same
for any ``epochs_per_sync`` (the JAX contract, harness.py:183-197).  Epochs
after the stopping one inside the last chunk still run; the state they
would change is frozen at the stopping epoch.

BatchNorm running statistics (the PINN's) are the model's persistent
buffers: training steps update them, the val pass and ``predict`` read
them, and they travel with the parameters, selected for the best epoch and
frozen at the stopping one in the same device-side ``_select_``, so
``FitResult.params["model"]`` holds them (the JAX package's
``batch_stats``, harness.py:292-358) and ``functional_call`` sees them.

Torch draws cannot match ``jax.random``, so a port's training trajectory
differs from the JAX package's for the same seed; its parameters start from
the same distributions (``reset_parameters``).

``checkpoint_dir`` saves the whole training state every
``checkpoint_every`` sync chunks and at the stop or the last epoch;
``resume_from`` restores it and continues.  A resumed run equals the
uninterrupted one bitwise: every epoch's draws are a function of (seed,
epoch) and every piece of state that carries across epochs is in the
checkpoint.  Not ported yet (ROADMAP queue A): ``mesh``/
``shuffle_scope="per_shard"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from openpystruct_tpu_torch.config import TrainConfig
from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.models.losses import trainable_l1l2_loss
from openpystruct_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

#: The file ``fit(checkpoint_dir=)`` writes and ``fit(resume_from=)`` reads.
STATE_FILE = "state.pt"


@dataclasses.dataclass
class FitResult:
    params: dict                   # best params (by val loss)
    state: dict                    # {"params", "step"} after the last epoch
    train_losses: np.ndarray
    val_losses: np.ndarray
    best_epoch: int = 0
    stopped_early: bool = False


def _generator(device, seed: int, *stream) -> torch.Generator:
    """A generator on ``device`` for the stream (seed, *stream)."""
    s = np.random.SeedSequence((seed,) + stream).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]) >> 1)


class _Optimizer:
    """The JAX harness's optax chain (``_make_optimizer``,
    harness.py:96-132) over ``.grad``: ``clip_by_global_norm(1.0)`` (g left
    as is below norm 1, else g / norm), L2 decay on the model's parameters
    added to the gradient, Adam (eps 1e-8), learning rate
    lr * lr_gamma^(step // steps_per_epoch) from the first update.
    ``decoupled=True`` is the chain's AdamW: the decay leaves the gradient
    and is applied to the model's parameters beside the Adam step (torch's
    ``AdamW`` computes p (1 - lr wd) - lr adam, optax p - lr (adam + wd p):
    equal in exact arithmetic).  Alpha is never decayed.  With
    ``train_alpha=False`` alpha is outside the clipped set and never moves
    (optax's ``set_to_zero``)."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int, model_params,
                 alpha, train_alpha: bool, decoupled: bool = False):
        model_params = list(model_params)
        groups = [{"params": model_params, "weight_decay": cfg.weight_decay}]
        if train_alpha:
            groups.append({"params": [alpha], "weight_decay": 0.0})
        self.params = model_params + ([alpha] if train_alpha else [])
        adam = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.adam = adam(groups, lr=cfg.learning_rate, betas=(0.9, 0.999),
                         eps=1e-8)
        self.cfg, self.steps_per_epoch, self.count = cfg, steps_per_epoch, 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:   # outside the graph: optax sees a zero
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_div_(grads, torch.where(norm < 1.0,
                                               torch.ones_like(norm), norm))
        lr = self.cfg.learning_rate * self.cfg.lr_gamma ** (
            self.count // self.steps_per_epoch)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1


def _early_stop_step(va, best_val, no_improve, stopped, patience: int):
    """One epoch of the early-stop rule on device tensors (harness.py:
    459-477): an epoch improves when its val loss is strictly below the best
    so far; ``patience`` epochs without improvement stop training, after the
    stopping epoch.  Returns (active, improved, best_val, no_improve,
    stopped); ``active`` is False for epochs after the stop."""
    active = ~stopped
    improved = (va < best_val) & active
    best_val = torch.where(improved, va, best_val)
    no_improve = torch.where(
        active, torch.where(improved, 0, no_improve + 1), no_improve)
    return active, improved, best_val, no_improve, stopped | (
        no_improve >= patience)


def _select_(dst: dict, src: dict, cond):
    """dst[k] <- src[k] where ``cond`` (a device bool), in place."""
    for k, v in dst.items():
        v.copy_(torch.where(cond, src[k].detach(), v))


def fit(
    model,
    X_train,
    Y_train,
    X_val,
    Y_val,
    cfg: TrainConfig = TrainConfig(),
    seed: Optional[int] = None,
    loss_fn: Optional[Callable] = None,
    loss_fn_builder: Optional[Callable] = None,
    param_loss_fn: Optional[Callable] = None,
    train_alpha: bool = True,
    decoupled_weight_decay: bool = False,
    epochs_per_sync: int = 8,
    verbose: bool = False,
    metrics=None,
    live_plot=None,
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    checkpoint_every: int = 1,
    device="cuda",
) -> FitResult:
    """Train ``model`` with the shared reference recipe on ``device``.

    ``model`` takes ``(x, generator=, train=)`` and has
    ``reset_parameters(generator)``: training starts from parameters drawn
    with ``torch.Generator().manual_seed(seed)`` (``seed`` defaults to
    ``cfg.seed``), and the module's parameters are trained in place.
    loss_fn(alpha, preds, targets) -> scalar; defaults to TrainableL1L2 with
    scalar box bounds at the train labels' global min/max
    (OpenPyStruct_FNN_MultiCase.py:313-314).  ``loss_fn_builder(Y_train)``
    returns the loss from the train labels on the device (the PINN's box
    bounds on its I slice, ``families.build_family``); it excludes
    ``loss_fn``.  ``param_loss_fn(params) -> scalar``, ``params`` the
    model's parameters by name (``dict(model.named_parameters())``), adds a
    term to the train and the val loss (the Bayesian families' scaled KL).
    ``decoupled_weight_decay=True`` decays as AdamW does (the GNN's).
    ``metrics``: a
    ``utils.MetricsLogger`` receiving one entry per epoch (train_loss,
    val_loss).  ``live_plot``: a ``viz.LiveLossPlot`` (or a path, for which
    ``fit`` makes one writing a self-refreshing PNG and closes it at the
    end) updated once per sync chunk with the histories so far, the
    reference's per-epoch live plot (OpenPyStruct_FNN_MultiCase.py:493-515)
    for headless hosts; it reads the host histories only, so the losses are
    bitwise the same with or without it.  ``FitResult.params`` holds the
    best params as
    ``{"model": {name: tensor}, "alpha": tensor}``, the model's persistent
    buffers (BatchNorm statistics) among the model's tensors;
    ``FitResult.state`` the
    params after the stopping (or last) epoch and the optimizer's step count.

    ``checkpoint_dir``: save the full training state to
    ``checkpoint_dir/state.pt`` (``train/checkpoint.py``'s atomic
    ``torch.save``) every ``checkpoint_every`` sync chunks and after the
    stopping or the last epoch: the live parameters, BatchNorm buffers and
    alpha, the optimizer's moments, steps and schedule count, the best
    tensors and best val loss, the early-stop counter and flag, the epoch,
    the loss histories and the seed.  ``resume_from``: a directory so
    written; the run continues from its state, and its seed wins over
    ``seed``, as the JAX package's checkpointed rng does.  With the same
    data and config the resumed run reproduces the uninterrupted one
    bitwise, for any ``epochs_per_sync`` on either side.
    """
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    owns_live_plot = isinstance(live_plot, str)
    if owns_live_plot:
        from openpystruct_tpu_torch.viz import LiveLossPlot

        live_plot = LiveLossPlot(live_plot)
    X_train, Y_train, X_val, Y_val = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (X_train, Y_train, X_val, Y_val))

    min_c, max_c = Y_train.min(), Y_train.max()
    if loss_fn_builder is not None:
        if loss_fn is not None:
            raise ValueError("pass loss_fn OR loss_fn_builder, not both")
        loss_fn = loss_fn_builder(Y_train)
    if loss_fn is None:
        def loss_fn(alpha, preds, targets):
            return trainable_l1l2_loss(alpha, preds, targets, min_c, max_c,
                                       cfg.box_constraint_coeff)

    model.to(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    alpha = torch.tensor(cfg.initial_alpha, dtype=torch.float32,
                         device=device, requires_grad=train_alpha)
    persistent = model.state_dict(keep_vars=True)
    stats = {k: v for k, v in model.named_buffers() if k in persistent}
    live = dict(model.named_parameters(), **stats, alpha=alpha)

    n_tr = X_train.shape[0]
    batch = min(cfg.batch_size, n_tr)
    steps = max(n_tr // batch, 1)
    opt = _Optimizer(cfg, steps, model.parameters(), alpha, train_alpha,
                     decoupled_weight_decay)
    model_params = dict(model.named_parameters())
    val_batch = min(cfg.batch_size, X_val.shape[0])
    full = max(X_val.shape[0] // val_batch, 1) * val_batch
    # the ragged val remainder is one extra batch, so the early-stop metric
    # sees every val sample (the reference's DataLoader keeps it,
    # OpenPyStruct_FNN_MultiCase.py:564-571)
    val_batches = [(X_val[i:i + val_batch], Y_val[i:i + val_batch])
                   for i in range(0, full, val_batch)]
    if X_val.shape[0] > full:
        val_batches.append((X_val[full:], Y_val[full:]))

    def compute_loss(Xb, Yb, generator, train):
        preds = model(Xb, generator=generator, train=train)
        # mild penalty on alpha deviating from its initial value
        # (OpenPyStruct_FNN_MultiCase.py:546-547)
        loss = loss_fn(alpha, preds, Yb) + (cfg.initial_alpha - alpha) ** 2
        if param_loss_fn is not None:
            loss = loss + param_loss_fn(model_params)
        return loss

    def run_epoch(epoch):
        g = _generator(device, seed, epoch)
        perm = torch.randperm(n_tr, generator=g, device=device)[:steps * batch]
        Xe = X_train[perm].reshape(steps, batch, *X_train.shape[1:])
        Ye = Y_train[perm].reshape(steps, batch, *Y_train.shape[1:])
        noise = float(np.float32(cfg.sigma_0) * np.power(
            np.float32(cfg.gamma_noise), np.float32(epoch)))
        losses = []
        for s in range(steps):
            Xb = Xe[s] + torch.randn(Xe[s].shape, generator=g,
                                     device=device) * noise
            loss = compute_loss(Xb, Ye[s], g, True)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            va = torch.stack([compute_loss(Xb, Yb, g, False)
                              for Xb, Yb in val_batches]).mean()
        return torch.stack(losses).mean(), va

    best = {k: v.detach().clone() for k, v in live.items()}
    final = {k: v.detach().clone() for k, v in live.items()}
    best_val = torch.tensor(float("inf"), device=device)
    no_improve = torch.zeros((), dtype=torch.int32, device=device)
    stopped = torch.zeros((), dtype=torch.bool, device=device)
    train_hist, val_hist = [], []
    best_epoch, stopped_host, epoch0 = 0, False, 0

    def full_state():
        return {"live": live, "final": final, "best": best,
                "best_val": best_val, "no_improve": no_improve,
                "stopped": stopped, "optimizer": opt.adam.state_dict(),
                "count": opt.count, "epoch0": epoch0,
                "best_epoch": best_epoch, "stopped_host": stopped_host,
                "train_hist": train_hist, "val_hist": val_hist,
                "seed": seed}

    if resume_from:
        ck = load_checkpoint(os.path.join(resume_from, STATE_FILE))
        with torch.no_grad():
            for name, dst in (("live", live), ("final", final),
                              ("best", best)):
                for k, v in dst.items():
                    v.copy_(ck[name][k])
        best_val, no_improve, stopped = (
            ck[k].to(device) for k in ("best_val", "no_improve", "stopped"))
        opt.adam.load_state_dict(ck["optimizer"])
        opt.count = ck["count"]
        epoch0, best_epoch = ck["epoch0"], ck["best_epoch"]
        stopped_host, seed = ck["stopped_host"], ck["seed"]
        train_hist, val_hist = list(ck["train_hist"]), list(ck["val_hist"])

    chunks_done = 0
    while epoch0 < cfg.num_epochs and not stopped_host:
        chunk = min(epochs_per_sync, cfg.num_epochs - epoch0)
        rows = []
        for i in range(chunk):
            tr, va = run_epoch(epoch0 + 1 + i)
            with torch.no_grad():
                was_stopped = stopped
                active, improved, best_val, no_improve, stopped = (
                    _early_stop_step(va, best_val, no_improve, stopped,
                                     cfg.patience))
                _select_(best, live, improved)
                # the stopping epoch's trained state is kept (the reference
                # breaks AFTER the epoch, OpenPyStruct_FNN_MultiCase.py:581-585)
                _select_(final, live, ~was_stopped)
            rows.append(torch.stack([tr, va, active.float(),
                                     improved.float(), stopped.float()]))
        rows = torch.stack(rows).cpu().numpy()   # the chunk's one host sync
        for i, (tr, va, act, imp, _) in enumerate(rows):
            if not act:
                break
            epoch = epoch0 + 1 + i
            train_hist.append(float(tr))
            val_hist.append(float(va))
            if metrics is not None:
                metrics.log(step=epoch, train_loss=float(tr),
                            val_loss=float(va))
            if imp:
                best_epoch = epoch
            if verbose:
                print(f"Epoch {epoch}/{cfg.num_epochs} | "
                      f"Train Loss={tr:.6f}, Val Loss={va:.6f}")
        epoch0 = len(train_hist)
        stopped_host = bool(rows[-1, 4])
        if verbose and stopped_host:
            print(f"Early stopping at epoch {epoch0}")
        if live_plot is not None:
            live_plot.update(train_hist, val_hist)
        chunks_done += 1
        if checkpoint_dir and (chunks_done % checkpoint_every == 0
                               or stopped_host
                               or epoch0 >= cfg.num_epochs):
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_checkpoint(os.path.join(checkpoint_dir, STATE_FILE),
                            full_state())
    if owns_live_plot:
        # fit made the figure, so fit releases it (matplotlib warns after
        # 20 open figures)
        live_plot.close()

    return FitResult(
        params={"model": {k: v for k, v in best.items() if k != "alpha"},
                "alpha": best["alpha"]},
        state={"params": {"model": {k: v for k, v in final.items()
                                    if k != "alpha"},
                          "alpha": final["alpha"]},
               "step": epoch0 * steps},
        train_losses=np.asarray(train_hist),
        val_losses=np.asarray(val_hist),
        best_epoch=best_epoch,
        stopped_early=stopped_host,
    )


def _unscale(Y, scaler):
    """``scaler.inverse_transform`` on a tensor, for numpy or tensor
    scalers."""
    def put(a):
        return torch.as_tensor(a, dtype=Y.dtype, device=Y.device)

    return Y * put(scaler.scale) + put(scaler.mean)


def predict(model, params, X, scaler_Y=None, seed: int = 0,
            clip=(0.0, 1e10), batch_size: Optional[int] = None,
            device="cuda"):
    """Batch inference with ``params`` (``FitResult.params``) on
    ``device``; optionally un-standardize with ``scaler_Y`` and clip (the
    reference's eval path, OpenPyStruct_FNN_MultiCase.py:611-628).

    ``batch_size`` chunks the forward pass; chunk i draws from a generator
    seeded from (seed, i), so the draws do not repeat across chunks.
    Returns a float32 tensor on ``device``."""
    device = resolve_device(device)
    model.to(device)
    state = {k: v.to(device) for k, v in params["model"].items()}
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    size = X.shape[0] if batch_size is None else batch_size
    with torch.no_grad():
        preds = torch.cat([
            functional_call(model, state, (X[i:i + size],), dict(
                generator=_generator(device, seed, ci), train=False))
            for ci, i in enumerate(range(0, X.shape[0], size))])
    if scaler_Y is not None:
        preds = _unscale(preds, scaler_Y)
        if clip is not None:
            preds = preds.clamp(*clip)
    return preds


def evaluate_r2(model, params, X_val, Y_val_std, scaler_Y, seed: int = 0,
                label_slice: Optional[slice] = None,
                batch_size: Optional[int] = None, device="cuda") -> float:
    """R^2 on un-standardized predictions and labels, both clipped at
    (0, 1e10), with ss_tot about the global label mean
    (OpenPyStruct_FNN_MultiCase.py:598-632); sums in float64.
    ``label_slice`` restricts the score to a column range (the PINN's
    headline metric is R^2 on the I slice,
    OpenPyStruct_PINN_MultiCase.py:831-852)."""
    preds = predict(model, params, X_val, scaler_Y, seed=seed,
                    batch_size=batch_size, device=device)
    labels = _unscale(torch.as_tensor(Y_val_std, dtype=torch.float32,
                                      device=preds.device), scaler_Y)
    labels = labels.clamp(0.0, 1e10)
    if label_slice is not None:
        preds = preds[:, label_slice]
        labels = labels[:, label_slice]
    preds, labels = preds.double(), labels.double()
    ss_res = ((labels - preds) ** 2).sum()
    ss_tot = ((labels - labels.mean()) ** 2).sum()
    return float(1.0 - ss_res / ss_tot)
