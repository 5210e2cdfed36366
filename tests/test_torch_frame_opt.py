"""Port: the frame optimizer and frame datagen (``opt/frame_opt.py``,
``datagen/frames.py``) against the JAX package's on the same inputs.

- ``frame_loss`` in both gradient modes: the four components and d/dI
  within 1e-10 relative in float64.
- ``optimize_frame_batched`` (float64, 2x2 frame, six load lanes, 80
  epochs, tolerance 3e-3, patience 5, so lanes stop at epochs 8 to 60 and
  two run to the end) against JAX's vmapped ``optimize_frame``: identical
  ``n_epochs`` and ``converged``, I, final loss and every lane's loss
  history (the port's ``optimize_frame(record_history=True)``) within
  1e-10 relative, in semi and in adjoint mode; each batched lane within
  1e-12 of its own ``optimize_frame``.
- ``chunk_size`` bitwise equal to the unchunked batch (float32), in the
  optimizer and in ``generate_frame_batch``'s chunked pivot pass.
- ``generate_frame_batch`` and ``frame_batch_to_columnar`` with both
  packages' load samplers patched to the same loads (float32, as both
  run): equal validity and ``n_epochs``, I, pivots, displacements and end
  forces within 1e-4 of each column's scale.
- ``generate_frame_dataset`` over ``bays_range = stories_range = (1, 2)``
  with the topology and load draws patched: the same rows per topology,
  padded lanes absent, each row's lengths consistent with its topology.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import FrameConfig as JFrameConfig
from openpystruct_tpu.datagen import frames as jframes
from openpystruct_tpu.fem import frame as jframe
from openpystruct_tpu.opt import frame_opt as jopt
from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.datagen import frames as tframes
from openpystruct_tpu_torch.fem import frame as tframe
from openpystruct_tpu_torch.opt import frame_opt as topt

OPT = dict(max_epochs=80, tolerance=3e-3, patience=5)
CFG, JCFG = FrameConfig(**OPT), JFrameConfig(**OPT)
UDL = -1e4 * np.array([0.3, 0.6, 1.0, 1.4, 2.0, 0.8])
LAT = 1e4 * np.array([1.8, 0.4, 1.0, 0.7, 1.2, 0.3])
FAST, JFAST = FrameConfig(max_epochs=25), JFrameConfig(max_epochs=25)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small systems: one intra-op thread runs them faster than many,
    above all beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    """max |a - b| relative to max |b| (tensors or arrays)."""
    a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("grad_mode", ["semi", "adjoint"])
def test_frame_loss_matches_jax(grad_mode):
    js = jframe.build_frame(2, 3, JCFG)
    ts = tframe.build_frame(2, 3, CFG, device="cpu")
    I = np.exp(np.random.default_rng(3).normal(size=(3, js.num_elems))
               * 0.5) * CFG.I0

    def jloss(i):
        i_solve = jax.lax.stop_gradient(i) if grad_mode == "semi" else i
        sol = jframe.solve_frame(i_solve, js, JCFG, jnp.float64)
        c = jopt.frame_loss(i, sol, JCFG, grad_mode=grad_mode)
        return c.total, c

    vg = jax.value_and_grad(jloss, has_aux=True)
    (_, jc), jg = jax.jit(jax.vmap(vg))(I)
    It = torch.tensor(I, requires_grad=True)
    if grad_mode == "semi":
        with torch.no_grad():
            sol = tframe.solve_frame(It, ts, CFG, torch.float64)
    else:
        sol = tframe.solve_frame(It, ts, CFG, torch.float64)
    tc = topt.frame_loss(It, sol, CFG, grad_mode=grad_mode)
    tc.total.sum().backward()
    for name in ("total", "primary", "bending_energy", "shear_energy"):
        np.testing.assert_allclose(getattr(tc, name).detach().numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-10)
    assert _rel(It.grad, jg) <= 1e-10


@pytest.fixture(scope="module", params=["semi", "adjoint"])
def trajectories(request):
    """JAX's and the port's batched runs on the six load lanes."""
    mode = request.param
    js = jframe.build_frame(2, 2, JCFG)
    ref = jax.jit(jax.vmap(lambda w, p: jopt.optimize_frame(
        js, JCFG, grad_mode=mode, record_history=True, dtype=jnp.float64,
        udl=w, lateral_load=p)))(UDL, LAT)
    ts = tframe.build_frame(2, 2, CFG, device="cpu")
    res = topt.optimize_frame_batched(ts, torch.tensor(UDL),
                                      torch.tensor(LAT), CFG,
                                      grad_mode=mode, dtype=torch.float64)
    return mode, ts, ref, res


def test_batched_trajectories_match_jax(trajectories):
    _, _, ref, res = trajectories
    n = res.n_epochs.numpy()
    np.testing.assert_array_equal(n, np.asarray(ref.n_epochs))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    # lanes stop at different epochs, some at the budget
    assert len(set(n.tolist())) >= 4 and (n == CFG.max_epochs).any()
    assert _rel(res.I, ref.I) <= 1e-10
    assert _rel(res.loss.total, ref.loss.total) <= 1e-10
    assert _rel(res.solution.end_forces, ref.solution.end_forces) <= 1e-10
    assert res.loss_history is None


def test_single_lanes_match_batched_and_jax(trajectories):
    mode, ts, ref, res = trajectories
    hist = np.asarray(ref.loss_history)
    for k in range(len(UDL)):
        one = topt.optimize_frame(ts, CFG, grad_mode=mode,
                                  record_history=True, dtype=torch.float64,
                                  udl=UDL[k], lateral_load=LAT[k])
        assert one.I.shape == (ts.num_elems,)
        assert int(one.n_epochs) == int(res.n_epochs[k])
        assert _rel(one.I, res.I[k]) <= 1e-12
        h = one.loss_history.numpy()
        np.testing.assert_array_equal(np.isnan(h), np.isnan(hist[k]))
        done = ~np.isnan(h)
        assert done.sum() == int(one.n_epochs)
        assert _rel(h[done], hist[k][done]) <= 1e-10


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunks_bitwise(chunk):
    ts = tframe.build_frame(2, 2, CFG, device="cpu")
    w, p = (torch.tensor(v, dtype=torch.float32) for v in (UDL, LAT))
    full = topt.optimize_frame_batched(ts, w, p, CFG)
    part = topt.optimize_frame_batched(ts, w, p, CFG, chunk_size=chunk)
    for a, b in ((full.I, part.I), (full.n_epochs, part.n_epochs),
                 (full.converged, part.converged),
                 (full.loss.total, part.loss.total),
                 (full.solution.displacements, part.solution.displacements)):
        assert torch.equal(a, b)
    assert part.I.shape == (len(UDL), ts.num_elems)


def test_generate_frame_batch_chunked_pivots_bitwise():
    args = (6, 2, 2, FAST)
    _, full = tframes.generate_frame_batch(torch.Generator().manual_seed(4),
                                           *args, device="cpu")
    _, part = tframes.generate_frame_batch(torch.Generator().manual_seed(4),
                                           *args, chunk_size=4, device="cpu")
    for name in ("udl", "valid", "pivot"):
        assert torch.equal(getattr(full, name), getattr(part, name))
    assert torch.equal(full.result.I, part.result.I)


def _patch_loads(monkeypatch, udl, lat):
    """Both packages' load samplers return udl[:B], lat[:B] (float32)."""
    w, p = np.float32(udl), np.float32(lat)
    monkeypatch.setattr(jframes, "sample_frame_loads",
                        lambda key, b, cfg=None, scale=None: (
                            jnp.asarray(w[:b]), jnp.asarray(p[:b])))
    monkeypatch.setattr(tframes, "sample_frame_loads",
                        lambda g, b, cfg=None, scale=None, device=None: (
                            torch.tensor(w[:b]), torch.tensor(p[:b])))


def _loads8():
    s = np.linspace(0.5, 1.5, 8)
    return FAST.udl * s, FAST.lateral_load * s[::-1]


def _hold_columns(tc, jc):
    assert tc.keys() == jc.keys()
    for k, v in jc.items():
        if not isinstance(v, list):
            assert tc[k] == v, k
        elif k in ("n_epochs", "num_bays", "num_stories"):
            assert tc[k] == v, k
        else:   # rows are ragged across topologies
            assert len(tc[k]) == len(v), k
            scale = max(np.abs(np.asarray(r, np.float64)).max() for r in v)
            for a, b in zip(tc[k], v):
                assert np.shape(a) == np.shape(b), k
                assert np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).max() <= (
                                  1e-4 * scale), k


def test_generate_frame_batch_matches_jax(monkeypatch):
    _patch_loads(monkeypatch, *_loads8())
    js, jb = jframes.generate_frame_batch(jax.random.PRNGKey(0), 8, 2, 2,
                                          JFAST)
    ts, tb = tframes.generate_frame_batch(torch.Generator(), 8, 2, 2, FAST,
                                          device="cpu")
    assert tb.result.I.dtype == torch.float32
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    assert tb.valid.all()
    np.testing.assert_array_equal(tb.result.n_epochs.numpy(),
                                  np.asarray(jb.result.n_epochs))
    assert _rel(tb.result.I, jb.result.I) <= 1e-4
    assert _rel(tb.pivot, jb.pivot) <= 1e-4
    _hold_columns(tframes.frame_batch_to_columnar(ts, tb),
                  jframes.frame_batch_to_columnar(js, jb))


def test_generate_frame_dataset_matches_jax(monkeypatch):
    _patch_loads(monkeypatch, *_loads8())
    bays = np.array([2, 1, 2, 2, 1, 2, 1, 2])
    stories = np.array([2, 2, 2, 2, 2, 2, 2, 2])
    monkeypatch.setattr(jframes, "sample_topologies",
                        lambda key, n, b=None, s=None: (bays, stories))
    monkeypatch.setattr(tframes, "sample_topologies",
                        lambda g, n, b=None, s=None: (bays, stories))
    jd = jframes.generate_frame_dataset(jax.random.PRNGKey(1), 8, JFAST,
                                        bays_range=(1, 2),
                                        stories_range=(1, 2))
    td = tframes.generate_frame_dataset(1, 8, FAST, bays_range=(1, 2),
                                        stories_range=(1, 2), device="cpu")
    _hold_columns(td, jd)
    # 3 rows of 1x2 then 5 of 2x2, the bucket's padding lanes dropped
    assert td["num_bays"] == [1] * 3 + [2] * 5
    for i in range(8):
        b, s = td["num_bays"][i], td["num_stories"][i]
        assert len(td["I_values"][i]) == s * (b + 1) + s * b
        assert len(td["displacements"][i]) == (b + 1) * (s + 1)
        assert len(td["axial_forces"][i]) == len(td["I_values"][i])


def test_sample_frame_loads_and_topologies():
    udl, lat = tframes.sample_frame_loads(torch.Generator().manual_seed(1),
                                          4096, device="cpu")
    cfg = FrameConfig()
    assert udl.dtype == torch.float32 and udl.shape == (4096,)
    assert (udl <= 0.5 * cfg.udl).all() and (udl >= 1.5 * cfg.udl).all()
    assert (lat >= 0.5 * cfg.lateral_load).all()
    assert (lat <= 1.5 * cfg.lateral_load).all()
    assert abs(float(udl.mean()) / cfg.udl - 1.0) < 0.02
    b, s = tframes.sample_topologies(torch.Generator().manual_seed(2), 2000)
    assert b.min() == 1 and b.max() == 10 and s.min() == 1 and s.max() == 10
    assert len(set(zip(b.tolist(), s.tolist()))) == 100


def test_dataclass_fields_match_jax():
    for t, j in ((topt.FrameOptResult, jopt.FrameOptResult),
                 (tframes.FrameBatch, jframes.FrameBatch),
                 (tframe.FrameSolution, jframe.FrameSolution)):
        assert ([f.name for f in dataclasses.fields(t)]
                == [f.name for f in dataclasses.fields(j)])
