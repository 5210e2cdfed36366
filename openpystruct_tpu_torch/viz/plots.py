"""Visualization suite (port of ``viz/plots.py``, copied: the module
imports no JAX).

Covers the reference's plot families:
- optimizer loss components (OpenPyStruct_BeamOpt.py:246-256);
- train/val loss curves (the per-epoch live plot,
  OpenPyStruct_FNN_MultiCase.py:493-515);
- beam diagnostics: I distribution as scaled thickness, pin/roller markers,
  force arrows, shear and moment diagrams (OpenPyStruct_BeamOpt.py:288-337);
- predicted-I beam rendering with winter-colormapped rectangles + colorbar
  (OpenPyStruct_FNN_MultiCase.py:694-817);
- frame member thickness ~ I^(1/3)
  (OpenPyStruct_FrameOpt_Discrete_Beta.py:237-291);
- PINN 3-panel I/deflection/rotation (OpenPyStruct_PINN_MultiCase.py:1021-1146).

All functions return the figure and never call plt.show() — callers decide
(savefig in headless runs).  They take numpy arrays (a caller holding
tensors passes ``t.cpu().numpy()``), except ``plot_frame``, which reads the
port's ``FrameStructure`` tensors wherever they lie.  matplotlib is
imported at the first plot, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    """A numpy copy of a tensor (on any device) or array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_loss_history(history, labels=("Total Loss", "Primary Loss (I Sum)",
                                       "Bending Energy Loss",
                                       "Shear Energy Loss")):
    """history: (epochs, 4) array (NaN-padded rows are dropped)."""
    plt = _plt()
    h = np.asarray(history)
    h = h[np.isfinite(h[:, 0])]
    fig, ax = plt.subplots(figsize=(10, 6))
    for i, lab in enumerate(labels[: h.shape[1]]):
        ax.plot(h[:, i], label=lab)
    ax.set_xlabel("Epochs")
    ax.set_ylabel("Loss")
    ax.legend()
    ax.set_title("Loss Components During Optimization")
    return fig


def plot_train_val_losses(train_losses, val_losses):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    e = np.arange(1, len(train_losses) + 1)
    ax.plot(e, train_losses, label="Train Loss", marker="o", color="blue")
    ax.plot(e, val_losses, label="Validation Loss", marker="x", color="red")
    ax.set_xlabel("Epochs")
    ax.set_ylabel("Loss")
    ax.set_title("Training and Validation Loss")
    ax.legend()
    ax.grid(True, linestyle="--", alpha=0.7)
    return fig


class LiveLossPlot:
    """The reference's per-epoch live training plot
    (``plt.ion()`` + ``live_plot`` refreshed every epoch,
    OpenPyStruct_FNN_MultiCase.py:493-515,594), headless-friendly.

    With ``path`` given (the normal headless case) the figure is atomically
    rewritten to that file on every update — point any image viewer /
    browser auto-refresh at it to watch training.  Without ``path`` and
    with an interactive matplotlib backend, it behaves like the reference:
    ``plt.ion()`` and an in-place window refresh.

    Usage: pass an instance (or just a path) to ``train.fit(live_plot=...)``
    or use ``train --watch out.png`` on the CLI.
    """

    def __init__(self, path=None, every: int = 1,
                 title: str = "Training Progress (Live)"):
        self.path = path
        self.every = max(int(every), 1)
        self.title = title
        self._n = 0
        plt = _plt()
        self._plt = plt
        self._fig, self._ax = plt.subplots(figsize=(10, 6))
        if path is None and plt.isinteractive():
            plt.ion()

    def update(self, train_losses, val_losses):
        """Redraw with the loss histories so far (called once per epoch /
        sync chunk by the harness)."""
        self._n += 1
        if self._n % self.every:
            return
        ax = self._ax
        ax.clear()
        e = np.arange(1, len(train_losses) + 1)
        ax.plot(e, train_losses, label="Train Loss", color="blue")
        ax.plot(e, val_losses, label="Validation Loss", color="red")
        ax.set_xlabel("Epochs")
        ax.set_ylabel("Loss")
        ax.set_title(self.title)
        ax.legend(loc="upper right")
        ax.grid(True, linestyle="--", alpha=0.7)
        if self.path is not None:
            import os

            # write-then-rename so watchers never see a half-written file;
            # format from the real path (savefig can't infer it from .tmp)
            fmt = os.path.splitext(self.path)[1].lstrip(".") or "png"
            tmp = f"{self.path}.tmp"
            self._fig.savefig(tmp, dpi=80, format=fmt)
            os.replace(tmp, self.path)
        elif self._plt.isinteractive():
            self._fig.canvas.draw_idle()
            self._plt.pause(0.001)
        # path=None on a non-interactive backend: nowhere useful to draw —
        # keep the histories flowing but skip the (warning-spewing) pause

    def close(self):
        self._plt.close(self._fig)


def plot_beam_diagrams(node_x, I, shear_forces, bending_moments,
                       roller_idx=(), force_idx=(), force_values=()):
    """3-panel I / shear / moment diagnostic (OpenPyStruct_BeamOpt.py:288-337).
    Indices are 0-based node indices."""
    plt = _plt()
    node_x = np.asarray(node_x)
    I = np.asarray(I)
    fig, axs = plt.subplots(3, 1, figsize=(20, 10), sharex=True)

    for i in range(len(I)):
        thickness = 15 * (I[i] / I.max()) ** (1 / 3)
        axs[0].plot(
            [node_x[i], node_x[i + 1]], [0, 0], linewidth=thickness,
            color="blue", alpha=0.3,
        )
    axs[0].scatter(node_x[0], 0, color="green", s=200, marker="^",
                   label="Pin Support")
    for k, n in enumerate(roller_idx):
        axs[0].scatter(node_x[n], 0, color="red", s=200, marker="o",
                       label="Roller Support" if k == 0 else "")
    for k, (n, f) in enumerate(zip(force_idx, force_values)):
        axs[0].annotate(
            "", xy=(node_x[n], -0.0125), xytext=(node_x[n], 0.0125),
            arrowprops=dict(color="red", arrowstyle="-|>"),
        )
    axs[0].set_ylabel("(Normalized I)$^{1/3}$")
    axs[0].grid(True)
    axs[0].legend()

    axs[1].step(node_x[:-1], np.asarray(shear_forces) / 1e3, where="post",
                color="red")
    axs[1].axhline(0, color="gray", linestyle="--", linewidth=0.8)
    axs[1].set_title("Shear Force Diagram")
    axs[1].set_ylabel("Shear Force (kN)")
    axs[1].grid(True)

    mids = (node_x[:-1] + node_x[1:]) / 2
    axs[2].plot(mids, np.asarray(bending_moments) / 1e3, color="blue",
                marker="o")
    axs[2].axhline(0, color="gray", linestyle="--", linewidth=0.8)
    axs[2].set_title("Bending Moment Diagram")
    axs[2].set_ylabel("Bending Moment (kN·m)")
    axs[2].set_xlabel("Beam Span (m)")
    axs[2].grid(True)
    fig.tight_layout()
    return fig


def plot_beam_prediction(L_beam, pred_I, rollers_x=(), force_cases_x=(),
                         force_cases_vals=()):
    """Beam schematic with predicted I as winter-colormapped centered
    rectangles, per-case force arrows, and a colorbar
    (OpenPyStruct_FNN_MultiCase.py:694-817)."""
    plt = _plt()
    import matplotlib.cm as cm

    pred = np.asarray(pred_I)
    nelem = len(pred)
    fig, ax = plt.subplots(figsize=(18, 7))
    ax.plot([0, L_beam], [0, 0], color="black", linewidth=3, label="Beam")
    ax.scatter(0, -0.15, marker="^", color="red", s=300, zorder=6)
    if len(rollers_x):
        ax.scatter(rollers_x, [0] * len(rollers_x), marker="o",
                   color="seagreen", s=200, zorder=5, edgecolors="k",
                   label="Rollers")

    all_vals = [v for case in force_cases_vals for v in case]
    fmax = max((abs(v) for v in all_vals), default=1.0)
    scale = 2.0 / fmax if fmax else 1.0
    colors = plt.get_cmap("Set1")(np.linspace(0, 1, max(len(force_cases_x), 1)))
    for ci, (fxs, fvs) in enumerate(zip(force_cases_x, force_cases_vals)):
        for fx, fv in zip(fxs, fvs):
            ax.annotate(
                "", xy=(fx, 0), xytext=(fx, abs(fv) * scale),
                arrowprops=dict(color=colors[ci], lw=2, arrowstyle="-|>"),
            )

    rng = pred.max() - pred.min() + 1e-8
    norm = plt.Normalize(pred.min(), pred.max())
    cmap = cm.winter
    bw = L_beam / nelem * 0.8
    xs = np.linspace(0, L_beam, nelem + 1)[:-1]
    from matplotlib.patches import Rectangle

    for x, v in zip(xs, pred):
        h = (v / rng) * 1.0
        ax.add_patch(Rectangle((x - bw / 2, -h / 2), bw, h, linewidth=0,
                               facecolor=cmap(norm(v)), alpha=0.6))
    sm = cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    cbar = fig.colorbar(sm, ax=ax, orientation="vertical", fraction=0.046,
                        pad=0.04)
    cbar.set_label("Predicted I (m$^4$)")
    ax.set_xlim(-5, L_beam + 5)
    ax.set_ylim(-2.5, 2.5)
    ax.set_title("Beam Setup with Applied Forces and Predicted I")
    ax.set_xlabel("Beam Length (m)")
    ax.grid(True, which="both", linestyle="--", linewidth=0.5, alpha=0.7)
    return fig


def plot_frame(structure, I):
    """Frame with member linewidth ~ (I/I_max)^(1/3)
    (OpenPyStruct_FrameOpt_Discrete_Beta.py:237-291)."""
    plt = _plt()
    xy = _host(structure.node_xy)
    elems = _host(structure.elems)
    I = _host(I)
    fig, ax = plt.subplots(figsize=(8, 8))
    for e, (a, b) in enumerate(elems):
        w = 6 * (I[e] / I.max()) ** (1 / 3)
        ax.plot([xy[a, 0], xy[b, 0]], [xy[a, 1], xy[b, 1]], color="steelblue",
                linewidth=w, alpha=0.8, solid_capstyle="round")
    base = _host(structure.fixed_mask)
    ax.scatter(xy[base, 0], xy[base, 1], marker="s", s=120, color="black",
               zorder=5, label="Fixed base")
    ax.set_aspect("equal")
    ax.set_title("Optimized Frame (member thickness ∝ I$^{1/3}$)")
    ax.legend()
    return fig


def _beam_schematic(ax, plt, L_beam, rollers_x, force_cases_x,
                    force_cases_vals, plot_forces):
    """Shared beam setup for the PINN panels: beam line, pin, rollers and
    (optionally) per-case colored force arrows."""
    ax.plot([0, L_beam], [0, 0], color="black", linewidth=3)
    ax.scatter(0, -0.15, marker="^", color="red", s=250, zorder=6,
               label="Pin")
    if len(rollers_x):
        ax.scatter(rollers_x, [0] * len(rollers_x), marker="o",
                   color="seagreen", s=160, zorder=5, edgecolors="k",
                   label="Rollers")
    if plot_forces and len(force_cases_x):
        all_vals = [v for case in force_cases_vals for v in case]
        fmax = max((abs(v) for v in all_vals), default=1.0)
        scale = 1.8 / fmax if fmax else 1.0
        colors = plt.get_cmap("Set1")(
            np.linspace(0, 1, max(len(force_cases_x), 1))
        )
        for ci, (fxs, fvs) in enumerate(zip(force_cases_x,
                                            force_cases_vals)):
            for fx, fv in zip(fxs, fvs):
                ax.annotate(
                    "", xy=(fx, 0), xytext=(fx, abs(fv) * scale),
                    arrowprops=dict(color=colors[ci], lw=2,
                                    arrowstyle="-|>"),
                )
    ax.set_xlim(-5, L_beam + 5)
    ax.grid(True, which="both", linestyle="--", linewidth=0.5, alpha=0.7)


def plot_pinn_panels(L_beam, pred_I, deflections, rotations,
                     rollers_x=(), force_cases_x=(), force_cases_vals=()):
    """The PINN's 3-panel prediction diagnostic
    (OpenPyStruct_PINN_MultiCase.py:1021-1146): each panel carries the
    beam schematic (pin/rollers; force arrows in the top panel only);
    top = predicted I as colormapped rectangles centered on the beam +
    colorbar, middle = predicted deflection field as a line over the
    schematic, bottom = predicted rotations as direction arrows
    (dx, dy) = r*(cos th, sin th) per node."""
    plt = _plt()
    import matplotlib.cm as cm
    from matplotlib.patches import FancyArrowPatch, Rectangle

    pred = np.asarray(pred_I)
    defl = np.asarray(deflections)
    rot = np.asarray(rotations)
    nelem = len(pred)
    fig, axs = plt.subplots(3, 1, figsize=(16, 15), sharex=True)

    # --- top: beam + forces + I rectangles -----------------------------
    ax = axs[0]
    _beam_schematic(ax, plt, L_beam, rollers_x, force_cases_x,
                    force_cases_vals, plot_forces=True)
    rng = pred.max() - pred.min() + 1e-8
    norm = plt.Normalize(pred.min(), pred.max())
    cmap = cm.winter
    bw = L_beam / nelem * 0.8
    xs = np.linspace(0, L_beam, nelem + 1)[:-1]
    for x, v in zip(xs, pred):
        h = (v / rng) * 1.0
        ax.add_patch(Rectangle((x - bw / 2, -h / 2), bw, h, linewidth=0,
                               facecolor=cmap(norm(v)), alpha=0.6))
    sm = cm.ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    cbar = fig.colorbar(sm, ax=ax, orientation="vertical", fraction=0.046,
                        pad=0.04)
    cbar.set_label("Predicted I (m$^4$)")
    ax.set_ylim(-2.5, 2.5)
    ax.set_title("Beam Setup with Applied Forces and I")

    # --- middle: deflection field over the schematic -------------------
    ax = axs[1]
    _beam_schematic(ax, plt, L_beam, rollers_x, force_cases_x,
                    force_cases_vals, plot_forces=False)
    node_x = np.linspace(0, L_beam, len(defl))
    ax.plot(node_x, defl, color="blue", marker="o", markersize=3,
            linestyle="-", label="Deflection")
    ax.set_ylabel("Deflection (m)")
    ax.set_title("PINN Predicted Displacements")
    lo, hi = float(defl.min()), float(defl.max())
    pad = 0.1 * max(abs(lo), abs(hi), 0.2)
    ax.set_ylim(lo - pad, hi + pad)

    # --- bottom: rotation arrows ----------------------------------------
    ax = axs[2]
    _beam_schematic(ax, plt, L_beam, rollers_x, force_cases_x,
                    force_cases_vals, plot_forces=False)
    r_scale = 10.0
    node_x = np.linspace(0, L_beam, len(rot))
    for x, th in zip(node_x, rot):
        dx, dy = r_scale * np.cos(th), r_scale * np.sin(th)
        ax.add_patch(FancyArrowPatch(
            posA=(x, 0.0), posB=(x + dx, dy), arrowstyle="-|>",
            mutation_scale=8, color="purple", linewidth=1, alpha=0.8,
        ))
    max_rot = float(np.max(np.abs(rot))) * r_scale * 1.2 + 1e-3
    ax.set_ylim(-max_rot, max_rot)
    ax.set_ylabel("Rotation (rad)")
    ax.set_xlabel("Beam Length (m)")
    ax.set_title("PINN Predicted Rotations")
    fig.tight_layout()
    return fig


def plot_pinn_fields(node_x, I, deflections, rotations):
    """PINN 3-panel (OpenPyStruct_PINN_MultiCase.py:1021-1146)."""
    plt = _plt()
    node_x = np.asarray(node_x)
    fig, axs = plt.subplots(3, 1, figsize=(14, 10), sharex=True)
    mids = (node_x[:-1] + node_x[1:]) / 2
    axs[0].plot(mids, np.asarray(I), color="navy", marker=".")
    axs[0].set_ylabel("I (m$^4$)")
    axs[1].plot(node_x, np.asarray(deflections), color="darkred")
    axs[1].set_ylabel("Deflection (m)")
    axs[2].plot(node_x, np.asarray(rotations), color="darkgreen")
    axs[2].set_ylabel("Rotation (rad)")
    axs[2].set_xlabel("Beam Span (m)")
    for ax in axs:
        ax.grid(True, linestyle="--", alpha=0.6)
    fig.tight_layout()
    return fig
