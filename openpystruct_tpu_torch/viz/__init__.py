"""Host-side matplotlib reporting (the reference's L5 layer); matplotlib is
imported at the first plot, not here."""

from openpystruct_tpu_torch.viz.plots import (
    LiveLossPlot,
    plot_loss_history,
    plot_train_val_losses,
    plot_beam_diagrams,
    plot_beam_prediction,
    plot_frame,
    plot_pinn_fields,
    plot_pinn_panels,
)

__all__ = [
    "LiveLossPlot",
    "plot_loss_history",
    "plot_train_val_losses",
    "plot_beam_diagrams",
    "plot_beam_prediction",
    "plot_frame",
    "plot_pinn_fields",
    "plot_pinn_panels",
]
