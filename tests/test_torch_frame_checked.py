"""Port: ``solve_frame_checked``'s escalation rule on near-singular lanes.

The JAX package's rule escalates a lane to float64 when the refinement
estimate exceeds tol or the float32 scaled pivot is below
``FRAME_PIVOT_TOL32 = 1e-9``.  On a near-singular float32 factor (pivots
~1e-6 to 1e-3) two refinement sweeps can report est < tol far from the
truth.  The port also escalates every lane below ``FRAME_VALID_PIVOT =
1e-3``, the pivot below which frame datagen calls a lane invalid; lanes
above it keep the estimate's verdict.  This departs from the JAX package on
purpose.

The batch: 2048 3x4 lanes, lognormal I (sigma 0.5 around I0) with 70-95% of
each lane's members at the 1e-8 clamp (numpy ``default_rng(11)``, float32),
``tol=1e-4``; the truth is the float64 dense solve.

- Every lane the port leaves in float32 is within 10 x tol of the truth, and
  lies above the pivot floor with est <= tol.
- Every lane the JAX package certifies in float32 beyond 10 x tol (lane
  1217: est 7.3e-5, pivot 3.9e-6, 0.101 off) is escalated by the port.
- On healthy lanes, far above the pivot floor, the port escalates the same
  lanes as the JAX package (``tests/test_torch_frame.py``'s
  ``checked_case`` holds the same on its three healthy lanes).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpystruct_tpu.config import FrameConfig as JFrameConfig
from openpystruct_tpu.fem import frame as jframe
from openpystruct_tpu.fem import frame_banded as jbanded
from openpystruct_tpu_torch.config import FrameConfig
from openpystruct_tpu_torch.fem import frame as tframe
from openpystruct_tpu_torch.fem import frame_banded as tbanded

CFG, JCFG = FrameConfig(), JFrameConfig()
LANES, TOL = 2048, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clamp_batch():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    js = jframe.build_frame(3, 4, JCFG)
    ts = tframe.build_frame(3, 4, CFG, device="cpu")
    E = ts.num_elems
    rng = np.random.default_rng(11)
    I = np.exp(rng.normal(size=(LANES, E)) * 0.5) * CFG.I0
    for k in range(LANES):
        frac = 0.7 + 0.25 * rng.random()
        I[k, rng.choice(E, size=int(frac * E), replace=False)] = 1e-8
    I = I.astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sol, info = tbanded.solve_frame_checked(torch.tensor(I), ts, CFG,
                                                tol=TOL)
        # as the JAX package runs by default, x64 off (this suite's
        # conftest turns it on; with it, JAX's float32 lanes differ)
        with jax.enable_x64(False):
            jsol, jinfo = jbanded.solve_frame_checked(jnp.asarray(I), js,
                                                      JCFG, tol=TOL)
    truth = tframe.solve_frame(torch.tensor(I, dtype=torch.float64), ts,
                               CFG, torch.float64, method="dense"
                               ).displacements.numpy().reshape(LANES, -1)
    piv32 = tbanded.frame_min_pivot(torch.tensor(I), ts, CFG).numpy()
    torch.set_num_threads(threads)

    def err(u):
        u = np.asarray(u, np.float64).reshape(LANES, -1)
        return np.abs(u - truth).max(1) / np.abs(truth).max(1)

    return dict(info=info, jinfo=jinfo, piv32=piv32,
                err=err(sol.displacements.numpy()),
                jerr=err(np.asarray(jsol.displacements)))


def test_no_float32_lane_beyond_ten_tol(clamp_batch):
    info, err = clamp_batch["info"], clamp_batch["err"]
    kept = ~info["used_f64"]
    assert kept.any() and info["used_f64"].any()
    assert err[kept].max() <= 10 * TOL, np.flatnonzero(kept & (err > 10 * TOL))
    assert (info["est"][kept] <= TOL).all()
    assert (info["pivot"][kept] >= tbanded.FRAME_VALID_PIVOT).all()
    # the lanes escalated and certified in float64 are within tol
    cert64 = info["used_f64"] & (info["est"] <= TOL)
    assert cert64.any() and err[cert64].max() <= TOL


def test_jax_false_certifications_escalated(clamp_batch):
    jinfo, jerr = clamp_batch["jinfo"], clamp_batch["jerr"]
    wrong = np.flatnonzero(~jinfo["used_f64"] & (jerr > 10 * TOL))
    # lane 1217 (JAX: est 7.3e-5, pivot 3.9e-6, error 0.101)
    assert 1217 in wrong
    assert clamp_batch["info"]["used_f64"][wrong].all()
    assert (clamp_batch["piv32"][wrong] < tbanded.FRAME_VALID_PIVOT).all()


def test_healthy_lanes_escalate_as_in_jax():
    """Healthy lognormal lanes (sigma 0.5 around I0, ``default_rng(12)``)
    sit far above the pivot floor: the port escalates the same lanes as the
    JAX package, and the lanes it keeps are within tol of float64."""
    js = jframe.build_frame(3, 4, JCFG)
    ts = tframe.build_frame(3, 4, CFG, device="cpu")
    rng = np.random.default_rng(12)
    I = (np.exp(rng.normal(size=(256, ts.num_elems)) * 0.5)
         * CFG.I0).astype(np.float32)
    sol, info = tbanded.solve_frame_checked(torch.tensor(I), ts, CFG, tol=TOL)
    with jax.enable_x64(False):
        _, jinfo = jbanded.solve_frame_checked(jnp.asarray(I), js, JCFG,
                                               tol=TOL)
    np.testing.assert_array_equal(info["used_f64"], jinfo["used_f64"])
    assert (info["pivot"] >= 10 * tbanded.FRAME_VALID_PIVOT).all()
    truth = tframe.solve_frame(torch.tensor(I, dtype=torch.float64), ts,
                               CFG, torch.float64, method="dense"
                               ).displacements
    d = (sol.displacements.double() - truth).abs().amax((1, 2))
    assert (d / truth.abs().amax((1, 2))).max() <= TOL
