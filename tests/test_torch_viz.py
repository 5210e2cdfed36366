"""Port: the plots (``viz/plots.py``) and ``fit(live_plot=)`` against the
JAX package's.

- Each plot function, on the same numpy inputs, draws what the JAX
  package's draws: every axes' title and labels, every line's data, width,
  colour, marker and label, every scatter's offsets, sizes and colours,
  every patch's geometry and colour, every annotation's end points.
- ``plot_frame`` on ``build_frame(2, 3)`` from each package (the port's
  tensors, the JAX package's arrays) draws the same member segments.
- ``LiveLossPlot`` writes a PNG over 1000 B, rewrites it on each update,
  ``every`` throttles, and its axes match the JAX package's.
- ``fit(live_plot=path)`` leaves the losses bitwise as they are without
  it, writes the PNG and closes the figure it made.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from openpystruct_tpu import viz as jviz  # noqa: E402
from openpystruct_tpu.config import FrameConfig as JFrameConfig  # noqa: E402
from openpystruct_tpu.fem import build_frame as jbuild_frame  # noqa: E402
from openpystruct_tpu_torch import viz as tviz  # noqa: E402
from openpystruct_tpu_torch.config import FrameConfig  # noqa: E402
from openpystruct_tpu_torch.families import FAMILIES, build_family  # noqa: E402
from openpystruct_tpu_torch.fem import build_frame  # noqa: E402
from openpystruct_tpu_torch.train import fit  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    plt.close("all")


def _axes_data(ax):
    lines = [(ln.get_xdata(), ln.get_ydata(), ln.get_linewidth(),
              mpl.colors.to_rgba(ln.get_color()), ln.get_marker(),
              ln.get_label(), ln.get_linestyle(), ln.get_alpha())
             for ln in ax.get_lines()]
    colls = [(type(c).__name__, c.get_offsets(),
              c.get_sizes() if hasattr(c, "get_sizes") else None,
              c.get_facecolors(), c.get_label()) for c in ax.collections]
    patches = []
    for p in ax.patches:
        geom = (p.get_path().vertices if not hasattr(p, "get_xy")
                else (p.get_xy(), p.get_width(), p.get_height()))
        if hasattr(p, "get_posA_posB"):
            geom = p.get_posA_posB()
        patches.append((type(p).__name__, geom, p.get_facecolor()))
    notes = [(t.xy, t.xyann) for t in ax.texts if hasattr(t, "xyann")]
    legend = ax.get_legend()
    return dict(
        title=ax.get_title(), xlabel=ax.get_xlabel(),
        ylabel=ax.get_ylabel(), xlim=ax.get_xlim(), ylim=ax.get_ylim(),
        lines=lines, colls=colls, patches=patches, notes=notes,
        legend=[t.get_text() for t in legend.get_texts()] if legend else [])


def _same(a, b, path="fig"):
    """Deep equality of nested lists/tuples/dicts of arrays and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.ma.MaskedArray)) or isinstance(
            b, (np.ndarray, np.ma.MaskedArray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _same_figure(fj, ft):
    assert len(fj.axes) == len(ft.axes)
    for k, (aj, at) in enumerate(zip(fj.axes, ft.axes)):
        _same(_axes_data(aj), _axes_data(at), f"axes[{k}]")
    assert fj.get_size_inches().tolist() == ft.get_size_inches().tolist()


def _inputs():
    rng = np.random.default_rng(0)
    n = 21
    node_x = np.linspace(0, 40, n)
    I = rng.uniform(0.1, 1.0, n - 1)
    return rng, n, node_x, I


def _cases():
    rng, n, node_x, I = _inputs()
    shear, moment = rng.normal(0, 1e4, n - 1), rng.normal(0, 1e5, n - 1)
    defl, rot = rng.normal(0, 1e-3, n), rng.normal(0, 1e-4, n)
    hist = np.vstack([np.linspace(10, 1, 50)] * 4).T
    hist[45:] = np.nan
    return {
        "plot_loss_history": ((hist,), {}),
        "plot_train_val_losses": ((np.linspace(1, 0.1, 20),
                                   np.linspace(1.2, 0.2, 20)), {}),
        "plot_beam_diagrams": ((node_x, I, shear, moment), dict(
            roller_idx=(5, 15), force_idx=(8, 11),
            force_values=(-1e5, -3e4))),
        "plot_beam_prediction": ((40.0, I), dict(
            rollers_x=(10.0, 30.0), force_cases_x=[[5.0, 20.0], [12.0]],
            force_cases_vals=[[-1e5, -2e5], [-5e4]])),
        "plot_pinn_fields": ((node_x, I, defl, rot), {}),
        "plot_pinn_panels": ((40.0, I, defl, rot), dict(
            rollers_x=[10.0, 30.0], force_cases_x=[[5.0, 20.0], [12.0]],
            force_cases_vals=[[-1e5, -2e5], [-5e4]])),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_plot_draws_what_jax_draws(name, tmp_path):
    args, kw = _cases()[name]
    fj = getattr(jviz, name)(*args, **kw)
    ft = getattr(tviz, name)(*args, **kw)
    _same_figure(fj, ft)
    out = tmp_path / f"{name}.png"
    ft.savefig(out)
    assert out.stat().st_size > 1000


def test_plot_frame_draws_the_same_members(tmp_path):
    tst = build_frame(2, 3, FrameConfig(), device="cpu")
    jst = jbuild_frame(2, 3, JFrameConfig())
    I = np.random.default_rng(1).uniform(1e-4, 1e-3, tst.num_elems)
    ft = tviz.plot_frame(tst, torch.tensor(I))
    fj = jviz.plot_frame(jst, I)
    _same_figure(fj, ft)
    segs = [(tuple(ln.get_xdata()), tuple(ln.get_ydata()))
            for ln in ft.axes[0].get_lines()]
    assert len(segs) == tst.num_elems == 15
    ft.savefig(tmp_path / "frame.png")
    assert (tmp_path / "frame.png").stat().st_size > 1000


def test_live_loss_plot(tmp_path):
    path = str(tmp_path / "live.png")
    lp = tviz.LiveLossPlot(path)
    lp.update([1.0], [1.2])
    size1 = os.path.getsize(path)
    lp.update([1.0, 0.8, 0.6], [1.2, 0.9, 0.7])
    assert size1 > 1000 and os.path.getsize(path) > 1000
    assert not os.path.exists(path + ".tmp")
    jp = jviz.LiveLossPlot(str(tmp_path / "jlive.png"))
    jp.update([1.0, 0.8, 0.6], [1.2, 0.9, 0.7])
    _same(_axes_data(jp._ax), _axes_data(lp._ax))
    lp.close()
    jp.close()


def test_live_plot_every_throttle(tmp_path):
    path = str(tmp_path / "live.png")
    lp = tviz.LiveLossPlot(path, every=5)
    for i in range(4):
        lp.update([1.0] * (i + 1), [1.0] * (i + 1))
    assert not os.path.exists(path)
    lp.update([1.0] * 5, [1.0] * 5)
    assert os.path.getsize(path) > 1000
    lp.close()


def test_fit_live_plot_leaves_losses_bitwise(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 6, 8)).astype(np.float32)
    Y = rng.normal(size=(40, 5)).astype(np.float32)
    cfg = dataclasses.replace(FAMILIES["fnn"].train, num_epochs=5,
                              batch_size=8)

    def run(**kw):
        model, _, fit_kwargs = build_family("fnn", feat_dim=8, nelem=5)
        return fit(model, X[:32], Y[:32], X[32:], Y[32:], cfg,
                   epochs_per_sync=2, device="cpu", **fit_kwargs, **kw)

    base = run()
    path = str(tmp_path / "watch.png")
    before = len(plt.get_fignums())
    seen = run(live_plot=path)
    assert os.path.getsize(path) > 1000
    assert len(plt.get_fignums()) == before     # fit closed its figure
    lp = tviz.LiveLossPlot(str(tmp_path / "mine.png"))
    mine = run(live_plot=lp)
    assert lp._n == 3       # one update per sync chunk: 2 + 2 + 1 epochs
    lp.close()
    for res in (seen, mine):
        assert res.train_losses.tobytes() == base.train_losses.tobytes()
        assert res.val_losses.tobytes() == base.val_losses.tobytes()
        for k, v in base.params["model"].items():
            assert torch.equal(res.params["model"][k], v), k
