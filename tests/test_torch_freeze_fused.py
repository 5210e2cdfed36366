"""Port: the epoch loop's freeze and early-stop bookkeeping folded into the
fused step (``beam_opt_step(lane_state=)``), on the CPU's plain version.

- Step by step: the fused body (``_make_fused_body``, one call an epoch
  that updates the lane state in place) against the torch body
  (``_make_freeze_body``: the step without lane state, then
  ``freeze_lanes``), bitwise over several epochs, semi and adjoint, at
  ragged batches, with done lanes, lanes reaching ``patience``, a NaN lane,
  a total exactly at ``best - tolerance``, and a batch done on entry.
- Whole runs: ``optimize_beam_batched`` and ``optimize_beam_compact``
  bitwise those forced through the torch body.

Imports neither JAX nor the JAX package.
"""

import pytest
import torch

from openpystruct_tpu_torch.config import (
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
)
from openpystruct_tpu_torch.datagen.sampler import sample_scenarios
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.opt import beam_opt as tbo

SCEN = ScenarioConfig(num_nodes=21, fixed_roller_tags=(3, 8, 14, 17, 20))
BEAM = BeamConfig(udl=-1000.0)
EPOCHS = 8
KEYS = ("I", "I_solved", "mu", "nu", "n_epochs", "best", "no_improve",
        "done", "stats")
MODES = pytest.mark.parametrize("mode", ["semi", "adjoint"])


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opt(mode, **kw):
    return OptimizerConfig(grad_mode=mode, tolerance=0.5, patience=3, **kw)


def _scenario(B, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return sample_scenarios(gen, B, SCEN, device="cpu", dtype=dtype)


def _entry_state(sc, opt, body, all_done=False):
    """A lane state at epoch 0, on ``sc``'s device, with every case the
    bookkeeping branches on: lane 0's total exactly at ``best - tolerance``
    (not an improvement), done lanes (lane % 7 == 3, and the whole second
    block of 32 lanes, which the card skips) with stats of their own, lanes
    one epoch short of ``patience`` that cannot improve (best -inf) or will
    (best inf), and a NaN I on the last lane of a batch of more than one and
    on lane 40 (done)."""
    B, nelem = sc.node_x.shape[0], sc.num_nodes - 1
    dev, dtype = sc.node_x.device, sc.node_x.dtype
    st = tbo._lane_state_init(torch.full((B, nelem), BEAM.I0, dtype=dtype,
                                         device=dev))
    lane = torch.arange(B, device=dev)
    st["mu"] = (torch.randn((B, nelem), generator=torch.Generator()
                            .manual_seed(B), dtype=dtype) * 1e-2).to(dev)
    st["nu"] = st["mu"].abs() * 1e-2
    if B > 1:
        st["I"][-1, nelem // 2] = float("nan")
    st["I"][lane == 40, 7] = float("nan")
    # lane 0's first total, from a step run on a copy
    total = body(_copy(st), 0)["stats"][0, 0]
    best = total + opt.tolerance
    while best - opt.tolerance < total:
        best = torch.nextafter(best, best.new_tensor(float("inf")))
    while best - opt.tolerance > total:
        best = torch.nextafter(best, best.new_tensor(-float("inf")))
    assert best - opt.tolerance == total
    st["best"][0] = best
    st["no_improve"][lane % 5 == 4] = opt.patience - 1
    st["best"][lane % 10 == 4] = -float("inf")
    st["best"][lane % 10 == 9] = float("inf")
    done = (lane % 7 == 3) | ((lane >= 32) & (lane < 64)) | all_done
    st["done"][done] = True
    st["n_epochs"][done] = 11
    st["stats"][done] = torch.arange(4.0, dtype=dtype, device=dev) + 2.0
    return st


def _copy(st):
    return {k: v.clone() for k, v in st.items()}


def _bodies(sc, opt, refine=1):
    step = tbo._make_kernel_step(sc, BEAM, opt, refine, True,
                                 sc.node_x.dtype)
    return tbo._make_fused_body(step, opt), tbo._make_freeze_body(step, opt)


def _assert_same(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)


@MODES
@pytest.mark.parametrize("B", [1, 31, 33, 70])
def test_fused_body_is_the_torch_body(B, mode):
    sc, opt = _scenario(B, 40 + B), _opt(mode)
    fused, plain = _bodies(sc, opt)
    a = _entry_state(sc, opt, plain)
    b = _copy(a)
    ins = {k: a[k] for k in ("done", "best", "no_improve", "n_epochs",
                             "I_solved")}
    for epoch in range(EPOCHS):
        a = fused(a, epoch)
        b = plain(b, epoch)
        _assert_same(a, b)
        # the fused body updates the lane state in place
        assert all(a[k] is v for k, v in ins.items())
        if epoch == 0:
            # a total exactly at best - tolerance is no improvement
            assert int(a["no_improve"][0]) == 1
    if B > 1:
        assert bool(torch.isnan(a["I"][-1]).any())
        assert bool(a["done"].any()) and not bool(a["done"].all())


@MODES
def test_fused_body_leaves_a_done_batch_alone(mode):
    sc, opt = _scenario(33, 7), _opt(mode)
    fused, plain = _bodies(sc, opt)
    entry = _entry_state(sc, opt, plain, all_done=True)
    a, b = fused(_copy(entry), 0), plain(_copy(entry), 0)
    _assert_same(a, b)
    _assert_same(a, entry)


def _forced_torch_body(monkeypatch):
    monkeypatch.setattr(tbo, "_make_fused_body", tbo._make_freeze_body)


def _results_same(a, b):
    for name in ("I", "I_solved", "n_epochs", "converged", "pivot"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0, equal_nan=True, msg=name)
    for name in ("total", "primary", "bending_energy", "shear_energy"):
        torch.testing.assert_close(getattr(a.loss, name),
                                   getattr(b.loss, name), rtol=0, atol=0,
                                   equal_nan=True, msg=name)
    for name in ("displacements", "shear_forces", "bending_moments"):
        torch.testing.assert_close(getattr(a.solution, name),
                                   getattr(b.solution, name), rtol=0,
                                   atol=0, equal_nan=True, msg=name)


@MODES
@pytest.mark.parametrize("run", ["batched", "compact"])
def test_optimizers_are_the_torch_body(run, mode, monkeypatch):
    sc = _scenario(16, 5, torch.float64)
    opt = OptimizerConfig(grad_mode=mode, max_epochs=40, tolerance=0.3,
                          patience=3)
    kw = dict(min_bucket=2) if run == "compact" else {}
    fn = getattr(tbo, f"optimize_beam_{run}")
    tk.reset_counts()
    fused = fn(sc, BEAM, opt, refine=1, **kw)
    calls = tk.PLAIN_CALLS["beam_opt_step"]
    _forced_torch_body(monkeypatch)
    plain = fn(sc, BEAM, opt, refine=1, **kw)
    assert tk.PLAIN_CALLS["beam_opt_step"] == 2 * calls > 0
    tk.reset_counts()
    assert len(set(fused.n_epochs.tolist())) > 1
    _results_same(fused, plain)
