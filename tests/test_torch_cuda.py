"""Port, on the card only: each CUDA kernel against its plain version, and
the datagen paths launching kernels only.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.  ``chip_smoke.py`` runs the same
checks at full width (B = 16384).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from openpystruct_tpu_torch.config import DATAGEN_OPT, BeamConfig, ScenarioConfig
from openpystruct_tpu_torch.datagen import (
    generate_batch,
    run_batch,
    sample_scenarios,
)
from openpystruct_tpu_torch.fem import accuracy as tacc
from openpystruct_tpu_torch.fem import solve_beam_checked
from openpystruct_tpu_torch.fem.beam import (
    BeamScenario,
    assemble_beam_system,
    constraint_mask,
    solve_beam_batched,
)
from openpystruct_tpu_torch.fem.solve import block_tridiag_matvec
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd
from openpystruct_tpu_torch.ops import block_stream as tbs
from openpystruct_tpu_torch.ops import block_stream_dd as tsd
from openpystruct_tpu_torch.ops import block_tridiag as tbt
from openpystruct_tpu_torch.opt import beam_opt

BEAM = BeamConfig(udl=-1000.0)
E, A, G = BEAM.E, BEAM.A, BEAM.G
# the largest per-lane difference of #4 to the plain float32 version on
# _systems(300, 7 or 8), fixed and random bridge, before the row step became
# a template (3.015e-2 and 9.057e+1, tools/block_tridiag_ab.py on the
# previous kernels, NVIDIA H100 80GB HBM3, 700.00 W), rounded up: float32
# keeps no digits on the random bridge
KERNEL_VS_PLAIN32 = {False: 3.02e-2, True: 9.06e+1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, seed, device, dtype, cfg=ScenarioConfig()):
    gen = torch.Generator().manual_seed(seed)
    sc = sample_scenarios(gen, B, cfg, device="cpu", dtype=torch.float64)
    nelem = sc.num_nodes - 1
    x = dict(
        I=torch.exp(torch.randn((B, nelem), generator=gen) * 0.3) * 0.5,
        mu=torch.randn((B, nelem), generator=gen) * 0.1,
        nu=torch.rand((B, nelem), generator=gen) * 1e-2 + 1e-4,
        Le=torch.diff(sc.node_x, dim=-1), free=(~constraint_mask(sc)).double(),
        loads=sc.point_loads, udl=sc.udl,
    )
    # float32 values first, so the float64 run sees the same inputs
    return {k: v.float().to(device=device, dtype=dtype) for k, v in x.items()}


def _systems(B, seed, device, dtype, cfg=ScenarioConfig()):
    """Jacobi-scaled beam systems (diag, upper, f) as solve_beam_batched
    hands them to the solve, assembled in float32."""
    gen = torch.Generator().manual_seed(seed)
    sc = sample_scenarios(gen, B, cfg, device="cpu", dtype=torch.float32)
    I = torch.exp(torch.randn((B, sc.num_nodes - 1), generator=gen) * 0.3) * 0.5
    d, u, f = assemble_beam_system(I, sc, E, A)
    s = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
    d = d * s[..., :, None] * s[..., None, :]
    u = u * s[..., :-1, :, None] * s[..., 1:, None, :]
    return tuple(t.to(device=device, dtype=dtype) for t in (d, u, f * s))


def _hold(kern, f64, f32, factor=2.0, floors=None):
    """Kernel error vs plain float64 no more than ``factor`` times the plain
    float32 version's, or 1e-5 of the output's scale (at least its entry
    in ``floors``, for an output float64 may give as exact zeros)."""
    for j, (k, t64, p32) in enumerate(zip(kern, f64, f32)):
        scale = max(t64.abs().max().item(), floors[j] if floors else 0.0)
        err_k = (k.double() - t64).abs().max().item() / scale
        err_p = (p32.double() - t64).abs().max().item() / scale
        assert err_k <= max(factor * err_p, 1e-5), (err_k, err_p)


# The worst value of _beam_lanes' random-support beams (spans to ~600 m)
# is set by float32's conditioning: rounded in another order (the kernel's
# FMA contraction), it lands up to 3.4x plain float32's error (the opt-step
# kernel at B = 16384, n = 101, adjoint; 2.2-3.1x at B = 1-300; and 7x on
# one of 69 lanes at B = 70, seed 3, NVIDIA H100 80GB HBM3, 700.00 W).  A
# wrong lane or node is off by O(1).
RANDOM_SUPPORTS = 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1, 2])
def test_beam_analysis_kernel(cuda, refine):
    keys = ("I", "Le", "free", "loads", "udl")
    x32, x64 = (_inputs(300, 1, cuda, dt) for dt in (torch.float32,
                                                       torch.float64))
    before = tk.LAUNCHES["beam_analysis"]
    kern = tk.beam_analysis(*(x32[k] for k in keys), E, A, refine)
    assert tk.LAUNCHES["beam_analysis"] == before + 1
    f64 = tk.beam_analysis_reference(*(x64[k] for k in keys), E, A, refine)
    f32 = tk.beam_analysis_reference(*(x32[k] for k in keys), E, A, refine)
    torch.cuda.synchronize()
    _hold(kern, f64, f32)
    assert torch.equal(kern[3] > 1e-9, f64[3] > 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_semi", [True, False], ids=["semi", "adjoint"])
def test_beam_opt_step_kernel(cuda, grad_semi):
    keys = ("I", "mu", "nu", "Le", "free", "loads", "udl")
    x32, x64 = (_inputs(300, 2, cuda, dt) for dt in (torch.float32,
                                                       torch.float64))
    tail = (0.009, 1.5, 400.0, E, A, G)
    kw = dict(grad_semi=grad_semi, refine=1)
    kern = tk.beam_opt_step(*(x32[k] for k in keys), *tail, **kw)
    f64 = tk.beam_opt_step_reference(*(x64[k] for k in keys), *tail, **kw)
    f32 = tk.beam_opt_step_reference(*(x32[k] for k in keys), *tail, **kw)
    torch.cuda.synchronize()
    _hold(kern, f64, f32)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _inputs(8, 3, cuda, torch.float64)
    with pytest.raises(TypeError):
        tk.beam_analysis(x["I"], x["Le"], x["free"], x["loads"], x["udl"],
                         E, A)
    x = _inputs(8, 3, cuda, torch.float32)
    with pytest.raises(ValueError):
        tk.beam_analysis(x["I"], x["Le"].cpu(), x["free"], x["loads"],
                         x["udl"], E, A)
    d, u, b = _systems(8, 3, cuda, torch.float64)
    with pytest.raises(TypeError):
        tbt.block_tridiag_solve(d, u, b)
    with pytest.raises(ValueError):
        tbt.block_tridiag_solve(d.float(), u.float()[:, 1:], b.float())


@pytest.mark.cuda
def test_batch_program_launches_kernels_only(cuda):
    sc = sample_scenarios(torch.Generator().manual_seed(4), 256,
                          device=cuda)
    tk.reset_counts()
    batch = run_batch(sc, BEAM, DATAGEN_OPT)
    assert tk.PLAIN_CALLS == {"beam_analysis": 0, "beam_opt_step": 0,
                              "beam_solve": 0}
    assert tk.LAUNCHES["beam_analysis"] == 1
    # the done flags are read every _SYNC_EVERY epochs: up to 3 epochs run
    # on frozen lanes after the last one converged
    extra = tk.LAUNCHES["beam_opt_step"] - int(batch.result.n_epochs.max())
    assert 0 <= extra < beam_opt._SYNC_EVERY
    assert batch.valid.all()
    tk.reset_counts()


def _lane_err(got, want, floor=0.0):
    """The worst lane's largest error relative to that lane's largest
    |want| (at least ``floor``)."""
    got, want = got.double().reshape(len(got), -1), want.double().reshape(
        len(want), -1)
    return ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp_min(floor)).max().item()


@pytest.mark.cuda
def test_beam_analysis_dd_kernel(cuda):
    """The float64 analysis kernel against its plain version on the same
    float32 random-bridge inputs: both compute in float64, so they agree
    to float32 rounding (bar: 1e-5 of the lane's scale)."""
    x = _inputs(300, 5, cuda, torch.float32, ScenarioConfig(random_bridge=True))
    args = [x[k] for k in ("I", "Le", "free", "loads", "udl")]
    before = tkd.LAUNCHES["beam_analysis_dd"]
    kern = tkd.beam_analysis_dd(*args, E, A)
    assert tkd.LAUNCHES["beam_analysis_dd"] == before + 1
    plain = tkd.beam_analysis_dd_reference(*args, E, A)
    torch.cuda.synchronize()
    for k, p in zip(kern[:3], plain[:3]):
        assert _lane_err(k, p) <= 1e-5
    assert ((kern[3].double() / plain[3].double() - 1).abs() <= 1e-3).all()
    assert (kern[0][..., 0] == 0).all()


@pytest.mark.cuda
def test_beam_opt_step_dd_kernel(cuda):
    x = _inputs(300, 6, cuda, torch.float32, ScenarioConfig(random_bridge=True))
    args = [x[k] for k in ("I", "mu", "nu", "Le", "free", "loads", "udl")]
    tail = (0.009, 1.5, 400.0, E, A, G)
    kern = tkd.beam_opt_step_dd(*args, *tail)
    plain = tkd.beam_opt_step_dd_reference(*args, *tail)
    torch.cuda.synchronize()
    for k, p in zip(kern[:4], plain[:4]):
        assert _lane_err(k, p) <= 1e-5
    assert ((kern[4].double() / plain[4].double() - 1).abs() <= 1e-3).all()


def _beam_lanes(B, n, seed, device):
    """Lanes-first float32 opt-step inputs of B beams of n nodes, from
    numpy: a pin at node 0, a roller at the last node and at random inner
    nodes, Le in [1, 3) m, lognormal I, point loads, udl -1000."""
    rng = np.random.default_rng(seed)
    free = np.ones((B, n, 3))
    free[:, 0, :2] = 0.0
    free[:, -1, 1] = 0.0
    free[:, 1:-1, 1] = rng.random((B, n - 2)) > 0.15
    x = dict(I=np.exp(rng.normal(size=(B, n - 1)) * 0.3) * 0.5,
             mu=rng.normal(size=(B, n - 1)) * 0.1,
             nu=rng.random((B, n - 1)) * 1e-2 + 1e-4,
             Le=1.0 + 2.0 * rng.random((B, n - 1)), free=free,
             loads=-3.5e5 * rng.random((B, n)) * (rng.random((B, n)) > 0.9),
             udl=np.full((B,), -1000.0))
    return [torch.from_numpy(x[k]).to(device=device, dtype=torch.float32)
            for k in ("I", "mu", "nu", "Le", "free", "loads", "udl")]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4, 101, 201])
@pytest.mark.parametrize("B", [1, 33, 300])
def test_beam_opt_step_dd_kernel_shapes(cuda, B, n):
    """The two-sweep float64 opt-step kernel against its plain version at
    ragged batches (33 and 300 lanes leave the last block part-filled) and
    meshes shorter than one staged tile (n = 3, 4) or spanning many (101,
    201): per-lane error no more than 1e-5 of the lane's scale, pivots
    within 1e-3 relative (phase 3b's rule)."""
    args = _beam_lanes(B, n, 100 * n + B, cuda)
    tail = (0.009, 1.5, 400.0, E, A, G)
    before = tkd.LAUNCHES["beam_opt_step_dd"]
    kern = tkd.beam_opt_step_dd(*args, *tail)
    assert tkd.LAUNCHES["beam_opt_step_dd"] == before + 1
    plain = tkd.beam_opt_step_dd_reference(*args, *tail)
    torch.cuda.synchronize()
    for k, p in zip(kern[:4], plain[:4]):
        assert k.shape == p.shape and k.is_contiguous()
        assert _lane_err(k, p) <= 1e-5
    assert ((kern[4].double() / plain[4].double() - 1).abs() <= 1e-3).all()


@pytest.mark.cuda
def test_beam_opt_step_dd_kernel_keeps_nan_lanes(cuda):
    """A lane with a NaN I stays NaN through the pivot's nan_min and the
    clamp's nan_max, as in the plain version; the other lanes are held by
    phase 3b's rule."""
    args = _beam_lanes(70, 101, 3, cuda)
    args[0][5, 40] = float("nan")
    tail = (0.009, 1.5, 400.0, E, A, G)
    kern = tkd.beam_opt_step_dd(*args, *tail)
    plain = tkd.beam_opt_step_dd_reference(*args, *tail)
    torch.cuda.synchronize()
    assert torch.isnan(kern[4][5]) and torch.isnan(kern[0][5]).any()
    for k, p in zip(kern, plain):
        assert torch.equal(torch.isnan(k), torch.isnan(p))
    keep = torch.arange(70, device=cuda) != 5
    for k, p in zip(kern[:4], plain[:4]):
        assert _lane_err(k[keep], p[keep]) <= 1e-5


@pytest.mark.cuda
def test_beam_opt_step_dd_rejects_a_strided_input(cuda):
    """The kernel reads the lanes-first layout as it lies: a transposed view
    raises instead of being copied, and nothing launches."""
    args = _beam_lanes(40, 101, 4, cuda)
    tail = (0.009, 1.5, 400.0, E, A, G)
    before = tkd.LAUNCHES["beam_opt_step_dd"]
    for i in (0, 4):
        bad = list(args)
        bad[i] = args[i].movedim(0, -1).contiguous().movedim(-1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="contiguous"):
            tkd.beam_opt_step_dd(*bad, *tail)
    assert tkd.LAUNCHES["beam_opt_step_dd"] == before


ANALYSES = pytest.mark.parametrize("dd", [False, True],
                                   ids=["analysis", "analysis_dd"])
# The float32 analysis kernel, bitwise the seven-pass kernel it replaced,
# lands up to 8.7x plain float32's worst value on _beam_lanes' random
# supports (B = 1, n = 201; 4.4-4.9x at B = 31 and 33, n = 101 and 201;
# NVIDIA H100 80GB HBM3, 700.00 W): float32 rounded in another order.  A
# wrong lane or node is off by O(1).
ANALYSIS_SUPPORTS = 10.0


def _force_floors(args):
    """Floors of the force scales for outputs float64 may give as exact
    zeros (the end moments of a simply supported element): V on w Le / 2,
    M on w Le^2 / 12."""
    w, le = args[6].abs().max().item(), args[3].max().item()
    return (0.0, w * le / 2.0, w * le * le / 12.0, 0.0)


def _analysis(dd, args, refine=1):
    """The analysis wrapper (#1, or #7 with ``dd``) on ``_beam_lanes``'s
    inputs."""
    ana = [args[i] for i in (0, 3, 4, 5, 6)]
    if dd:
        return tkd.beam_analysis_dd(*ana, E, A)
    return tk.beam_analysis(*ana, E, A, refine)


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3, 9, 101, 201])
@pytest.mark.parametrize("B", [1, 31, 33, 256, 16384])
def test_beam_analysis_kernel_shapes(cuda, B, n, refine):
    """The fused-sweep float32 analysis (#1) at one lane, ragged batches
    (31 and 33 lanes), a compaction bucket, the full datagen batch, and
    meshes shorter than one staged tile (n = 2, 3, 9) or spanning many
    (101, 201), at every refinement count: lanes-first outputs, one launch
    and no plain call, each output's error against the plain float64
    version no more than ANALYSIS_SUPPORTS times the plain float32
    version's, or 1e-5 of its scale, and u_x exactly zero."""
    args = _beam_lanes(B, n, 100 * n + B + refine, cuda)
    tk.reset_counts()
    kern = _analysis(False, args, refine)
    assert tk.LAUNCHES["beam_analysis"] == 1
    assert tk.PLAIN_CALLS == {"beam_analysis": 0, "beam_opt_step": 0,
                              "beam_solve": 0}
    ana = [args[i] for i in (0, 3, 4, 5, 6)]
    f64 = tk.beam_analysis_reference(*(a.double() for a in ana), E, A,
                                     refine)
    f32 = tk.beam_analysis_reference(*ana, E, A, refine)
    torch.cuda.synchronize()
    for k, p in zip(kern, f32):
        assert k.shape == p.shape and k.is_contiguous() and k.is_cuda
    # a simply supported single element (B = 1, n = 2) has end moments of
    # exactly 0: V and M are held on the scale of their fixed-end terms
    _hold(kern, f64, f32, ANALYSIS_SUPPORTS, floors=_force_floors(args))
    assert (kern[0][..., 0] == 0).all()
    tk.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 101, 201])
@pytest.mark.parametrize("B", [1, 31, 33, 256, 16384])
def test_beam_analysis_dd_kernel_shapes(cuda, B, n):
    """The two-sweep float64 analysis (#7) at the same shapes: lanes-first
    outputs, one launch and no plain call, per-lane error no more than 1e-5
    of the lane's scale (V and M at least their fixed-end terms') and
    pivots within 1e-3 relative (phase 3b's rule), u_x exactly zero."""
    args = _beam_lanes(B, n, 100 * n + B, cuda)
    tkd.reset_counts()
    kern = _analysis(True, args)
    assert tkd.LAUNCHES["beam_analysis_dd"] == 1
    assert tkd.PLAIN_CALLS == {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
    plain = tkd.beam_analysis_dd_reference(
        *(args[i] for i in (0, 3, 4, 5, 6)), E, A)
    torch.cuda.synchronize()
    for k, p, floor in zip(kern[:3], plain[:3], _force_floors(args)):
        assert k.shape == p.shape and k.is_contiguous() and k.is_cuda
        assert _lane_err(k, p, floor) <= 1e-5
    assert ((kern[3].double() / plain[3].double() - 1).abs() <= 1e-3).all()
    assert (kern[0][..., 0] == 0).all()
    tkd.reset_counts()


@pytest.mark.cuda
@ANALYSES
def test_beam_analysis_kernels_keep_nan_lanes(cuda, dd):
    """A lane with a NaN I comes out NaN in u (u_x too), V, M and the
    pivot, where the plain version's does; the other lanes are bitwise
    those of a run without the NaN (lanes are independent)."""
    args = _beam_lanes(70, 101, 3, cuda)
    clean = _analysis(dd, args)
    args[0][5, 40] = float("nan")
    kern = _analysis(dd, args)
    ana = [args[i] for i in (0, 3, 4, 5, 6)]
    plain = (tkd.beam_analysis_dd_reference(*ana, E, A) if dd else
             tk.beam_analysis_reference(*ana, E, A, 1))
    torch.cuda.synchronize()
    assert torch.isnan(kern[0][5]).all() and torch.isnan(kern[3][5])
    for k, p in zip(kern, plain):
        assert torch.equal(torch.isnan(k), torch.isnan(p))
    keep = torch.arange(70, device=cuda) != 5
    for k, c in zip(kern, clean):
        assert torch.equal(k[keep], c[keep])


@pytest.mark.cuda
@ANALYSES
def test_beam_analysis_kernels_reject_what_they_do_not_take(cuda, dd):
    """The analysis kernels read the callers' lanes-first tensors as they
    lie: a transposed view raises instead of being copied, the launcher
    refuses CPU tensors, and nothing launches."""
    args = _beam_lanes(40, 101, 4, cuda)
    launches = tkd.LAUNCHES if dd else tk.LAUNCHES
    name = "beam_analysis_dd" if dd else "beam_analysis"
    launch = tkd.launch_beam_analysis_dd if dd else tk.launch_beam_analysis
    before = launches[name]
    for i in (0, 4):
        bad = list(args)
        bad[i] = args[i].movedim(0, -1).contiguous().movedim(-1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="contiguous"):
            _analysis(dd, bad)
    with pytest.raises(ValueError, match="CUDA"):
        launch(*(args[i].cpu() for i in (0, 3, 4, 5, 6)), E, A)
    with pytest.raises(ValueError):
        launch(args[0], args[3].cpu(), *(args[i] for i in (4, 5, 6)), E, A)
    assert launches[name] == before


MODES = pytest.mark.parametrize("grad_semi", [True, False],
                                ids=["semi", "adjoint"])


@pytest.mark.cuda
@MODES
@pytest.mark.parametrize("n", [3, 4, 101, 201])
@pytest.mark.parametrize("B", [1, 33, 300, 16384])
def test_beam_opt_step_kernel_shapes(cuda, B, n, grad_semi):
    """The fused-sweep float32 opt-step kernel at ragged batches (33 and 300
    lanes leave the last block part-filled), one lane, the full datagen
    batch, and meshes shorter than one staged tile (n = 3, 4) or spanning
    many (101, 201): each output's error against the plain float64 version
    no more than RANDOM_SUPPORTS times the plain float32 version's, or 1e-5
    of its scale."""
    args = _beam_lanes(B, n, 100 * n + B, cuda)
    tail = (0.009, 1.5, 400.0, E, A, G)
    kw = dict(grad_semi=grad_semi, refine=1)
    before = tk.LAUNCHES["beam_opt_step"]
    kern = tk.beam_opt_step(*args, *tail, **kw)
    assert tk.LAUNCHES["beam_opt_step"] == before + 1
    f64 = tk.beam_opt_step_reference(*(a.double() for a in args), *tail, **kw)
    f32 = tk.beam_opt_step_reference(*args, *tail, **kw)
    torch.cuda.synchronize()
    for k, p in zip(kern, f32):
        assert k.shape == p.shape and k.is_contiguous()
    _hold(kern, f64, f32, RANDOM_SUPPORTS)


@pytest.mark.cuda
@MODES
@pytest.mark.parametrize("refine", [0, 1, 2])
def test_beam_opt_step_kernel_refine(cuda, refine, grad_semi):
    """Every refinement count against the plain float32 and float64
    versions on fixed-bridge lanes."""
    keys = ("I", "mu", "nu", "Le", "free", "loads", "udl")
    x32, x64 = (_inputs(300, 9, cuda, dt) for dt in (torch.float32,
                                                       torch.float64))
    tail = (0.009, 1.5, 400.0, E, A, G)
    kw = dict(grad_semi=grad_semi, refine=refine)
    kern = tk.beam_opt_step(*(x32[k] for k in keys), *tail, **kw)
    f64 = tk.beam_opt_step_reference(*(x64[k] for k in keys), *tail, **kw)
    f32 = tk.beam_opt_step_reference(*(x32[k] for k in keys), *tail, **kw)
    torch.cuda.synchronize()
    _hold(kern, f64, f32)


@pytest.mark.cuda
@MODES
def test_beam_opt_step_kernel_keeps_nan_lanes(cuda, grad_semi):
    """A lane with a NaN I stays NaN through the clamp's nan_max, where the
    plain version's does; the other lanes are bitwise those of a run
    without the NaN (lanes are independent)."""
    args = _beam_lanes(70, 101, 3, cuda)
    tail = (0.009, 1.5, 400.0, E, A, G)
    kw = dict(grad_semi=grad_semi, refine=1)
    clean = tk.beam_opt_step(*args, *tail, **kw)
    args[0][5, 40] = float("nan")
    kern = tk.beam_opt_step(*args, *tail, **kw)
    f32 = tk.beam_opt_step_reference(*args, *tail, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(kern[0][5]).any()
    for k, p in zip(kern, f32):
        assert torch.equal(torch.isnan(k), torch.isnan(p))
    keep = torch.arange(70, device=cuda) != 5
    for k, c in zip(kern, clean):
        assert torch.equal(k[keep], c[keep])


@pytest.mark.cuda
@MODES
def test_beam_opt_step_rejects_a_strided_input(cuda, grad_semi):
    """The kernel reads the lanes-first layout as it lies: a transposed view
    raises instead of being copied, and nothing launches."""
    args = _beam_lanes(40, 101, 4, cuda)
    tail = (0.009, 1.5, 400.0, E, A, G)
    before = tk.LAUNCHES["beam_opt_step"]
    for i in (0, 4):
        bad = list(args)
        bad[i] = args[i].movedim(0, -1).contiguous().movedim(-1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="contiguous"):
            tk.beam_opt_step(*bad, *tail, grad_semi=grad_semi)
    assert tk.LAUNCHES["beam_opt_step"] == before


@pytest.mark.cuda
def test_random_bridge_batch_launches_kernels_only(cuda):
    """The default rescue of a random-bridge batch on the card runs the
    float64 kernels: no plain version, and every lane kept."""
    for m in (tk, tkd):
        m.reset_counts()
    batch = generate_batch(torch.Generator().manual_seed(7), 512,
                           ScenarioConfig(random_bridge=True), device=cuda)
    assert tk.PLAIN_CALLS == {"beam_analysis": 0, "beam_opt_step": 0,
                              "beam_solve": 0}
    assert tkd.PLAIN_CALLS == {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
    assert tkd.LAUNCHES["beam_analysis_dd"] == 1
    assert tkd.LAUNCHES["beam_opt_step_dd"] > 0
    assert batch.valid.float().mean().item() >= 0.99
    for m in (tk, tkd):
        m.reset_counts()


@pytest.mark.cuda
def test_adjoint_rescue_stays_off_the_host_unless_asked(cuda):
    """In adjoint mode a random-bridge CUDA batch has no float64 kernel to
    rescue with: the default raises, and rescue="f64" rescues on the host
    in float64 as asked."""
    opt = dataclasses.replace(DATAGEN_OPT, grad_mode="adjoint", max_epochs=60)
    rb = ScenarioConfig(random_bridge=True)
    with pytest.raises(NotImplementedError, match="beam_opt_step_dd"):
        generate_batch(torch.Generator().manual_seed(8), 64, rb, opt_cfg=opt,
                       device=cuda)
    tkd.reset_counts()
    batch = generate_batch(torch.Generator().manual_seed(8), 64, rb,
                           opt_cfg=opt, device=cuda, rescue="f64")
    assert tkd.LAUNCHES == {"beam_analysis_dd": 0, "beam_opt_step_dd": 0}
    assert batch.valid.is_cuda and batch.valid.float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [False, True], ids=["thomas", "streamed"])
def test_block_tridiag_kernels(cuda, streamed):
    """Kernel #4 and the streamed kernel #6 against the plain version, on
    fixed-bridge and random-bridge systems."""
    for seed, cfg in ((7, ScenarioConfig()),
                      (8, ScenarioConfig(random_bridge=True))):
        x32 = _systems(300, seed, cuda, torch.float32, cfg)
        x64 = [t.double() for t in x32]
        mod, name = ((tbs, "block_tridiag_solve_streamed") if streamed
                     else (tbt, "block_tridiag_solve"))
        before = mod.LAUNCHES[name]
        kern = (tbs.block_tridiag_solve_streamed(*x32) if streamed
                else tbt.launch_thomas(*x32))
        assert mod.LAUNCHES[name] == before + 1
        torch.cuda.synchronize()
        _hold([kern], [tbt.thomas_reference(*x64)],
              [tbt.thomas_reference(*x32)])


@pytest.mark.cuda
def test_beam_solve_kernel(cuda):
    """The explicit-RHS solve (#3) on scenario beams: one launch, no plain
    call, x and the pivot held against the plain float64 version by
    _hold's rule."""
    x32, x64 = (_inputs(300, 9, cuda, dt) for dt in (torch.float32,
                                                       torch.float64))
    gen = torch.Generator().manual_seed(9)
    rhs = torch.randn((300, 101, 3), generator=gen) * 1e4
    args32 = [x32[k] for k in ("I", "Le", "free")] + [rhs.to(cuda)]
    args64 = [x64[k] for k in ("I", "Le", "free")] + [rhs.to(cuda).double()]
    tk.reset_counts()
    kern = tk.beam_solve(*args32, E, A, 1)
    assert tk.LAUNCHES["beam_solve"] == 1
    assert tk.PLAIN_CALLS == {"beam_analysis": 0, "beam_opt_step": 0,
                              "beam_solve": 0}
    f64 = tk.beam_solve_reference(*args64, E, A, 1)
    f32 = tk.beam_solve_reference(*args32, E, A, 1)
    torch.cuda.synchronize()
    _hold(kern, f64, f32)
    tk.reset_counts()


# The explicit-RHS solve (#3) on _beam_lanes' random supports: float32
# keeps few digits of x there (one lane of B = 31, n = 51, refine 2 lands
# 7.7e-4 of the batch's scale from float64 both in the kernel and in the
# plain version on the CPU, 5.1e-5 in the plain version on the card, whose
# rsqrt is not IEEE's; NVIDIA H100 80GB HBM3, 700.00 W), so x is held by
# its backward error, chip_smoke.py phase 3c's rule, and the pivot against
# float64 within SOLVE_SUPPORTS times plain float32's error, as the
# analysis kernel's (ANALYSIS_SUPPORTS).  A wrong lane or node is off by
# O(1) in both.
SOLVE_SUPPORTS = ANALYSIS_SUPPORTS


def _solve_backward_errors(args, x):
    """Per-lane backward error of x for K(I) x = rhs (masked, in float64):
    max_i |b - K x|_i over max_i (|K| |x| + |b|)_i in Jacobi-scaled rows,
    chip_smoke.py's ``backward_errors``; inf on a non-finite lane."""
    I, Le, free, rhs = (a.double() for a in args)
    d, u, b = tk._assemble3(tk._stiffness(I, Le, E, E * A), free, rhs)
    u, x = u[:, :-1], x.double()
    s = torch.rsqrt(torch.diagonal(d, dim1=-2, dim2=-1))
    r = (b - block_tridiag_matvec(d, u, x)) * s
    den = (block_tridiag_matvec(d.abs(), u.abs(), x.abs()) + b.abs()) * s
    err = r.abs().amax((1, 2)) / den.amax((1, 2)).clamp_min(1e-300)
    return torch.where(torch.isfinite(err), err, torch.inf)


def _solve_lanes(B, n, seed, device):
    """_beam_lanes' I, Le and mask, and a right-hand side that loads every
    DOF, the axial one included (the analysis gradient's rarely does)."""
    args = _beam_lanes(B, n, seed, device)
    rhs = np.random.default_rng(seed + 1).normal(size=(B, n, 3)) * 1e4
    return [args[0], args[3], args[4],
            torch.from_numpy(rhs).to(device=device, dtype=torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 3, 9, 51, 101, 201])
@pytest.mark.parametrize("B", [1, 31, 33, 256, 16384])
def test_beam_solve_kernel_shapes(cuda, B, n, refine):
    """#3 at one lane, ragged batches (31 and 33 lanes), a compaction
    bucket, the full batch, and meshes shorter than one staged tile (n = 2,
    3) or spanning one to many (9, 51, 101, 201), at every refinement
    count, on a right-hand side with an axial component: lanes-first x,
    one launch and no plain call, x's worst backward error no more than
    twice plain float32's (or 1e-6), the pivot within SOLVE_SUPPORTS times
    plain float32's error to float64 (or 1e-5 of its scale)."""
    args = _solve_lanes(B, n, 1000 * n + B + refine, cuda)
    tk.reset_counts()
    kern = tk.beam_solve(*args, E, A, refine)
    assert tk.LAUNCHES["beam_solve"] == 1
    assert tk.PLAIN_CALLS["beam_solve"] == 0
    f64 = tk.beam_solve_reference(*(a.double() for a in args), E, A, refine)
    f32 = tk.beam_solve_reference(*args, E, A, refine)
    torch.cuda.synchronize()
    assert kern[0].shape == (B, n, 3) and kern[0].is_contiguous()
    assert kern[1].shape == (B,)
    assert (kern[0][..., 0].abs().amax() > 0).item()   # the axial chain ran
    bw_k, bw_p = (_solve_backward_errors(args, x[0]) for x in (kern, f32))
    assert bw_k.max().item() <= max(2.0 * bw_p.max().item(), 1e-6), (
        bw_k.max().item(), bw_p.max().item())
    _hold([kern[1]], [f64[1]], [f32[1]], SOLVE_SUPPORTS)
    tk.reset_counts()


@pytest.mark.cuda
def test_beam_solve_kernel_non_finite_lanes(cuda):
    """Lanes the system leaves singular or undefined come out non-finite
    where the plain version's do, entry by entry, and in the pivot: a NaN
    I, an I = 0 on the first element (a zero diagonal) and inside the
    beam, no support at all.  Their values are not held.  The other lanes
    are bitwise those of a run without them (lanes are independent)."""
    args = _solve_lanes(70, 101, 5, cuda)
    clean = tk.beam_solve(*args, E, A, 1)
    args[0][5, 40] = float("nan")
    args[0][9, 0] = 0.0
    args[0][12, 60] = 0.0
    args[2][20] = 1.0
    kern = tk.beam_solve(*args, E, A, 1)
    plain = tk.beam_solve_reference(*args, E, A, 1)
    torch.cuda.synchronize()
    assert not torch.isfinite(kern[0][5]).any()
    assert torch.isnan(kern[1][5]) and torch.isnan(kern[1][9])
    for k, p in zip(kern, plain):
        assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[[5, 9, 12, 20]] = False
    for k, c in zip(kern, clean):
        assert torch.equal(k[keep], c[keep])


@pytest.mark.cuda
def test_beam_solve_rejects_what_it_does_not_take(cuda):
    """#3 reads the callers' lanes-first tensors as they lie: a transposed
    view raises instead of being copied, the launcher refuses CPU tensors
    and float64 ones, and nothing launches."""
    args = _solve_lanes(40, 101, 6, cuda)
    tk.reset_counts()
    for i in (0, 2, 3):
        bad = list(args)
        bad[i] = args[i].movedim(0, -1).contiguous().movedim(-1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], args[i])
        with pytest.raises(ValueError, match="contiguous"):
            tk.beam_solve(*bad, E, A, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_beam_solve(*(a.cpu() for a in args), E, A, 1)
    with pytest.raises(ValueError):
        tk.launch_beam_solve(args[0], args[1].cpu(), *args[2:], E, A, 1)
    with pytest.raises(TypeError):
        tk.beam_solve(*args[:3], args[3].double(), E, A, 1)
    assert tk.LAUNCHES["beam_solve"] == 0
    assert tk.PLAIN_CALLS["beam_solve"] == 0


def _solves(cuda, n, B):
    """Launches of the block-Thomas kernel ``block_tridiag.uses_streamed``
    names for B lanes of n rows, after checking the other launched none."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    four = tbt.LAUNCHES["block_tridiag_solve"]
    six = tbs.LAUNCHES["block_tridiag_solve_streamed"]
    if tbt.uses_streamed(n, B, sms):
        assert four == 0
        return six
    assert six == 0
    return four


@pytest.mark.cuda
def test_solve_sym_backward_and_split_path_on_the_card(cuda):
    """solve_beam_batched on a CUDA batch launches the block-Thomas solve,
    forward and backward; deflections and dL/dI held against the plain
    float64 route by _hold's rule."""
    gen = torch.Generator().manual_seed(10)
    sc = sample_scenarios(gen, 64, device="cpu", dtype=torch.float64)
    I64 = torch.exp(torch.randn((64, 100), generator=gen) * 0.3) * 0.5
    outs = {}
    for name, dev, dt in (("kernel", cuda, torch.float32),
                          ("plain32", "cpu", torch.float32),
                          ("plain64", "cpu", torch.float64)):
        I = I64.to(device=dev, dtype=dt).requires_grad_(True)
        s = sc.map(lambda t: (t.to(dt) if t.is_floating_point() else t)
                   .to(dev))
        tbt.reset_counts()
        tbs.reset_counts()
        sol = solve_beam_batched(I, s, E, A, refine=1)
        (g,) = torch.autograd.grad((sol.bending_moments**2).sum() * 1e-9
                                   + (sol.deflections**2).sum() * 1e3, I)
        outs[name] = [sol.deflections.detach().cpu(), g.cpu()]
        if name == "kernel":
            # every solve on the kernel uses_streamed names for 64 lanes
            assert _solves(cuda, 101, 64) == 4
            assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 0
    tbt.reset_counts()
    _hold(outs["kernel"], outs["plain64"], outs["plain32"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["semi", "adjoint"])
def test_split_optimizer_launches_kernels_only(cuda, mode):
    """optimize_beam_batched(fused=False) on a CUDA batch: every solve,
    forward and (in adjoint mode) backward, is a kernel launch."""
    sc = sample_scenarios(torch.Generator().manual_seed(13), 128, device=cuda)
    opt = dataclasses.replace(DATAGEN_OPT, grad_mode=mode, max_epochs=8)
    for m in (tk, tbt, tbs):
        m.reset_counts()
    res = beam_opt.optimize_beam_batched(sc, BEAM, opt, refine=1, fused=False)
    # every solve on the kernel uses_streamed names for 128 lanes
    assert _solves(cuda, 101, 128) > 0
    assert tbs.PLAIN_CALLS["block_tridiag_solve_streamed"] == 0
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 0
    assert tk.LAUNCHES["beam_opt_step"] == 0
    assert res.solution.deflections.is_cuda
    assert torch.isfinite(res.I).all()
    assert (res.I >= DATAGEN_OPT.clamp_min).all()
    for m in (tk, tbt, tbs):
        m.reset_counts()


@pytest.mark.cuda
def test_beam_analysis_gradient_on_the_card(cuda):
    x32, x64 = (_inputs(128, 11, cuda, dt) for dt in (torch.float32,
                                                        torch.float64))
    grads = {}
    for name, x, fn in (("kernel", x32, tk.beam_analysis),
                        ("plain32", x32, tk.beam_analysis_reference),
                        ("plain64", x64, tk.beam_analysis_reference)):
        I = x["I"].clone().requires_grad_(True)
        tk.reset_counts()
        u, V, M, _ = fn(I, x["Le"], x["free"], x["loads"], x["udl"], E, A, 1)
        loss = (M**2).sum() * 1e-9 + (V**2).sum() * 1e-7 + (u[..., 1]**2
                                                             ).sum() * 1e3
        (grads[name],) = torch.autograd.grad(loss, I)
        if name == "kernel":
            # forward #1, backward #3, nothing plain
            assert tk.LAUNCHES == {"beam_analysis": 1, "beam_opt_step": 0,
                                   "beam_solve": 1}
            assert not any(tk.PLAIN_CALLS.values())
    torch.cuda.synchronize()
    tk.reset_counts()
    _hold([grads["kernel"]], [grads["plain64"]], [grads["plain32"]])


@pytest.mark.cuda
def test_solve_beam_checked_stays_on_the_card(cuda):
    for m in (tk, tkd, tbt):
        m.reset_counts()
    sc = sample_scenarios(torch.Generator().manual_seed(12), 256,
                          ScenarioConfig(random_bridge=True), device=cuda)
    I = torch.full((256, 100), 0.05, device=cuda)
    sol, info = solve_beam_checked(I, sc, E, A, tol=1e-4)
    assert info["used_dd"].is_cuda and info["used_dd"].any()
    assert tkd.LAUNCHES["beam_analysis_dd"] == 1
    assert tkd.PLAIN_CALLS["beam_analysis_dd"] == 0
    assert tbt.PLAIN_CALLS["block_tridiag_solve"] == 0
    assert sol.deflections.is_cuda
    for m in (tk, tkd, tbt):
        m.reset_counts()


@pytest.mark.cuda
def test_block_tridiag_kernels_unchanged_by_templating(cuda):
    """#4 and #6 after their row step became a template over the scalar
    type: still bitwise equal to each other, and off the plain float32
    version run on the same card by no more than before (per-lane, of the
    lane's scale; FMA contraction is the only difference)."""
    for seed, cfg in ((7, ScenarioConfig()),
                      (8, ScenarioConfig(random_bridge=True))):
        x32 = _systems(300, seed, cuda, torch.float32, cfg)
        kern4 = tbt.launch_thomas(*x32)
        kern6 = tbs.block_tridiag_solve_streamed(*x32)
        plain = tbt.thomas_reference(*x32)
        torch.cuda.synchronize()
        assert torch.equal(kern4, kern6)
        assert _lane_err(kern4, plain) <= KERNEL_VS_PLAIN32[cfg.random_bridge]


def _spd_systems(B, n, seed, device):
    """Random symmetric positive definite block-tridiagonal systems,
    float32."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, n, 3, 3))
    d = d @ d.transpose(0, 1, 3, 2) + 6.0 * np.eye(3)
    u = rng.normal(size=(B, n - 1, 3, 3)) * 0.3
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.float32)
                 for a in (d, u, rng.normal(size=(B, n, 3))))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4, 101])
def test_bidi_kernel(cuda, n):
    """Kernel #5 against its plain version (the same two chains in
    float32) by _hold's rule, on 300 lanes (a ragged last block): random
    SPD systems at n = 3 and 4, fixed-bridge beam systems at n = 101."""
    x32 = (_systems(300, 15, cuda, torch.float32) if n == 101
           else _spd_systems(300, n, n, cuda))
    before = tbt.LAUNCHES["block_tridiag_solve_bidi"]
    kern = tbt.block_tridiag_solve(*x32, bidi=True)
    assert tbt.LAUNCHES["block_tridiag_solve_bidi"] == before + 1
    torch.cuda.synchronize()
    _hold([kern], [tbt.thomas_reference(*(t.double() for t in x32))],
          [tbt.thomas_bidi_reference(*x32)])
    d, u, b = _spd_systems(4, 2, 0, cuda)
    with pytest.raises(ValueError, match="n >= 3"):
        tbt.block_tridiag_solve(d, u, b, bidi=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4, 5, 17, 18, 64, 65, 101, 1001])
@pytest.mark.parametrize("B", [1, 33, 300, 2048, 16384])
def test_bidi_kernel_shapes(cuda, B, n):
    """Kernel #5 on lanes-first random SPD systems: both parities of n, one
    row a side (n = 3), two on the left and one on the right (4), the edges
    of its 8-row tiles on either side of the meeting row (17, 18: row m at a
    left tile's first row; 64, 65; 1001: a partial first right tile), one
    lane, ragged blocks (33, 300) and the lanes per block it picks on an
    H100 (132 SMs): 4 (B = 1, 33, 300), 8 (2048) and 32 (16384).  Against
    the plain float32 and float64 versions by _hold's rule, the plain
    float32 one the same two chains."""
    x32 = _spd_systems(B, n, 1000 * n + B + 11, cuda)
    before = tbt.LAUNCHES["block_tridiag_solve_bidi"]
    kern = tbt.launch_thomas_bidi(*x32)
    assert tbt.LAUNCHES["block_tridiag_solve_bidi"] == before + 1
    torch.cuda.synchronize()
    assert kern.shape == (B, n, 3) and kern.is_contiguous()
    _hold([kern], [tbt.thomas_reference(*(t.double() for t in x32))],
          [tbt.thomas_bidi_reference(*x32)])


@pytest.mark.cuda
def test_bidi_kernel_keeps_nan_lanes(cuda):
    """A lane with a NaN diagonal block, on each side of the meeting row,
    goes NaN; every other lane, in its block and in others, is bitwise what
    a clean run gives."""
    x32 = list(_systems(300, 17, cuda, torch.float32))
    clean = tbt.launch_thomas_bidi(*x32)
    x32[0] = x32[0].clone()
    x32[0][40, 20] = float("nan")
    x32[0][41, 80] = float("nan")
    kern = tbt.launch_thomas_bidi(*x32)
    torch.cuda.synchronize()
    assert torch.isnan(kern[40]).any() and torch.isnan(kern[41]).any()
    assert torch.isfinite(clean).all()
    keep = (torch.arange(300, device=cuda) != 40) & (
        torch.arange(300, device=cuda) != 41)
    assert torch.equal(kern[keep], clean[keep])


@pytest.mark.cuda
def test_bidi_kernel_rejects_what_it_does_not_take(cuda):
    """The kernel reads the lanes-first systems as they lie: a transposed
    view raises instead of being copied, and so does a mesh of fewer than
    three nodes.  Nothing is counted."""
    x32 = _spd_systems(40, 101, 4, cuda)
    before = tbt.LAUNCHES["block_tridiag_solve_bidi"]
    for i in range(3):
        bad = list(x32)
        bad[i] = x32[i].movedim(0, 1).contiguous().movedim(1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], x32[i])
        with pytest.raises(ValueError, match="contiguous"):
            tbt.launch_thomas_bidi(*bad)
    with pytest.raises(ValueError, match="n >= 3"):
        tbt.launch_thomas_bidi(*_spd_systems(40, 2, 4, cuda))
    assert tbt.LAUNCHES["block_tridiag_solve_bidi"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 101, 1001])
@pytest.mark.parametrize("B", [1, 33, 300, 2048, 4096, 16384])
def test_streamed_kernel_shapes(cuda, B, n):
    """Kernel #6 on lanes-first random SPD systems at the edges of its
    8-row tiles and rings (n = 1, 2, 3, 64, 65, 101, 1001), one lane, ragged
    blocks (33, 300) and each lane count per block the kernel picks on an
    H100 (132 SMs): 4 lanes up to 1056 lanes (B = 1, 33, 300), 8 up to
    2112 (2048), 16 up to 4224 (4096), 32 above (16384).  Against the
    plain float32 and float64 versions by _hold's rule, and bitwise equal to
    the one-launch kernel #4, whose row step it repeats."""
    x32 = _spd_systems(B, n, 1000 * n + B, cuda)
    kern4 = tbt.launch_thomas(*x32)
    before = tbs.LAUNCHES["block_tridiag_solve_streamed"]
    kern = tbs.launch_thomas_streamed(*x32)
    assert tbs.LAUNCHES["block_tridiag_solve_streamed"] == before + 1
    torch.cuda.synchronize()
    assert kern.shape == (B, n, 3) and kern.is_contiguous()
    _hold([kern], [tbt.thomas_reference(*(t.double() for t in x32))],
          [tbt.thomas_reference(*x32)])
    assert torch.equal(kern, kern4)


@pytest.mark.cuda
def test_streamed_kernel_keeps_nan_lanes(cuda):
    """A lane with a NaN diagonal block stays NaN from that row on; every
    other lane is bitwise what a clean run gives (lanes are independent)."""
    x32 = list(_systems(300, 17, cuda, torch.float32))
    clean = tbs.block_tridiag_solve_streamed(*x32)
    x32[0] = x32[0].clone()
    x32[0][40, 60] = float("nan")
    kern = tbs.block_tridiag_solve_streamed(*x32)
    torch.cuda.synchronize()
    assert torch.isnan(kern[40]).any()
    assert torch.isfinite(clean).all()
    keep = torch.arange(300, device=cuda) != 40
    assert torch.equal(kern[keep], clean[keep])


@pytest.mark.cuda
def test_streamed_kernel_rejects_a_strided_input(cuda):
    """The kernel reads the lanes-first systems as they lie: a transposed
    view raises instead of being copied, and nothing launches."""
    x32 = _spd_systems(40, 101, 4, cuda)
    before = tbs.LAUNCHES["block_tridiag_solve_streamed"]
    for i in range(3):
        bad = list(x32)
        bad[i] = x32[i].movedim(0, 1).contiguous().movedim(1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], x32[i])
        with pytest.raises(ValueError, match="contiguous"):
            tbs.launch_thomas_streamed(*bad)
    assert tbs.LAUNCHES["block_tridiag_solve_streamed"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 51, 101, 201])
@pytest.mark.parametrize("B", [1, 33, 300, 2048, 4096, 16384])
def test_resident_kernel_shapes(cuda, B, n):
    """Kernel #4 on lanes-first random SPD systems at the edges of its
    8-row tiles (n = 1, 2, 3) and at the split path's meshes (51, 101,
    201), one lane, ragged blocks (33, 300) and the lane counts at which the
    launcher picks each kind of block on an H100 (132 SMs): one block per SM
    of ceil(B / 132) lanes up to 16 (B = 1 to 2048), else the fewest rounds
    of blocks of at most 16 lanes, one round (4096 up to n = 101) or more
    (16384).  Against the plain float32 and float64 versions by _hold's
    rule, and bitwise equal to the streamed kernel #6, whose row step it
    repeats."""
    x32 = _spd_systems(B, n, 1000 * n + B + 7, cuda)
    lanes = tbt.resident_lanes(B, n)
    assert 1 <= lanes <= 16
    before = tbt.LAUNCHES["block_tridiag_solve"]
    kern = tbt.launch_thomas(*x32)
    assert tbt.LAUNCHES["block_tridiag_solve"] == before + 1
    kern6 = tbs.launch_thomas_streamed(*x32)
    torch.cuda.synchronize()
    assert kern.shape == (B, n, 3) and kern.is_contiguous()
    _hold([kern], [tbt.thomas_reference(*(t.double() for t in x32))],
          [tbt.thomas_reference(*x32)])
    assert torch.equal(kern, kern6)


@pytest.mark.cuda
def test_resident_kernel_keeps_nan_lanes(cuda):
    """A lane with a NaN diagonal block stays NaN from that row on; every
    other lane, in its block and in others, is bitwise what a clean run
    gives."""
    x32 = list(_systems(300, 17, cuda, torch.float32))
    clean = tbt.launch_thomas(*x32)
    x32[0] = x32[0].clone()
    x32[0][40, 60] = float("nan")
    kern = tbt.launch_thomas(*x32)
    torch.cuda.synchronize()
    assert torch.isnan(kern[40]).any()
    assert torch.isfinite(clean).all()
    keep = torch.arange(300, device=cuda) != 40
    assert torch.equal(kern[keep], clean[keep])


@pytest.mark.cuda
def test_resident_kernel_rejects_what_it_does_not_take(cuda):
    """The kernel reads the lanes-first systems as they lie: a transposed
    view raises instead of being copied; a mesh whose one lane of C and y
    does not fit a block's shared memory raises at launch.  Nothing is
    counted."""
    x32 = _spd_systems(40, 101, 4, cuda)
    before = tbt.LAUNCHES["block_tridiag_solve"]
    for i in range(3):
        bad = list(x32)
        bad[i] = x32[i].movedim(0, 1).contiguous().movedim(1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], x32[i])
        with pytest.raises(ValueError, match="contiguous"):
            tbt.launch_thomas(*bad)
    long = _spd_systems(1, 5000, 5, cuda)
    assert tbt.resident_lanes(1, 5000) == 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        tbt.launch_thomas(*long)
    assert tbt.LAUNCHES["block_tridiag_solve"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 300])
def test_streamed_dd_kernel(cuda, B):
    """Kernel #9 against its plain version on the same float64 systems
    (random-bridge lanes at n = 101, assembled in float64): both compute in
    float64 and write float32, so they agree to float32 rounding (bar: 1e-5
    of the lane's scale, pivots within 1e-3 relative)."""
    x = _inputs(B, 14, cuda, torch.float32, ScenarioConfig(random_bridge=True))
    sys_dd = tsd.assemble_beam_system_dd(
        *(x[k] for k in ("I", "Le", "free", "loads", "udl")), E, A)[:3]
    before = tsd.LAUNCHES["solve_dd_streamed"]
    kern = tsd.solve_dd_streamed(*sys_dd)
    assert tsd.LAUNCHES["solve_dd_streamed"] == before + 1
    plain = tsd.thomas_dd_reference(*sys_dd)
    torch.cuda.synchronize()
    assert kern[0].dtype == torch.float32 and kern[1].shape == (B,)
    assert _lane_err(kern[0], plain[0]) <= 1e-5
    assert ((kern[1].double() / plain[1].double() - 1).abs() <= 1e-3).all()
    with pytest.raises(TypeError):
        tsd.solve_dd_streamed(*(t.float() for t in sys_dd))


def _dd_routes(beam):
    """The streamed float64 beam solve of the (I, Le, free, loads, udl)
    float32 lanes ``beam`` three ways: the fused route (#9's beam mode),
    the unfused one (float64 assembly, then #9's system solve) and the
    plain version (the same assembly and the plain solve), each (u,
    pivot); each route's launch counted once, no plain call."""
    diag, upper, f, s = tsd.assemble_beam_system_dd(*beam, E, A)
    tsd.reset_counts()
    fused = tsd.solve_beam_dd_streamed(*beam, E, A)
    assert tsd.LAUNCHES == {"solve_dd_streamed": 0,
                            "solve_beam_dd_streamed": 1}
    x, piv = tsd.solve_dd_streamed(diag, upper, f)
    assert tsd.LAUNCHES == {"solve_dd_streamed": 1,
                            "solve_beam_dd_streamed": 1}
    assert not any(tsd.PLAIN_CALLS.values())
    tsd.reset_counts()
    xp, pp = tsd.thomas_dd_reference(diag, upper, f)
    return (fused, ((x.to(s.dtype) * s).float(), piv),
            ((xp.to(s.dtype) * s).float(), pp))


def _hold_dd_route(fused, unfused, plain):
    """The fused route bitwise the unfused one, and by phase 3d's rules
    against the plain version: per-lane error within 1e-5 of the lane's
    scale, pivots within a relative 1e-6."""
    for k, p in zip(fused, plain):
        assert k.dtype == torch.float32 and k.shape == p.shape
        assert k.is_contiguous() and k.is_cuda
    assert torch.equal(fused[0], unfused[0])
    assert torch.equal(fused[1], unfused[1])
    assert _lane_err(fused[0], plain[0]) <= 1e-5
    assert ((fused[1].double() / plain[1].double() - 1).abs() <= 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 9, 101, 1001])
@pytest.mark.parametrize("B", [1, 31, 33, 256, 16384])
def test_streamed_dd_kernel_shapes(cuda, B, n):
    """Kernel #9 on _beam_lanes' random-support beams assembled in
    float64, at meshes shorter than one 8-row tile (n = 2, 3), across a
    tile edge (9) and over many (101, 1001), one lane, ragged blocks (31,
    33) and each lane count per block the launcher picks on an H100 (4 up
    to 1056 lanes, 32 at 16384): the system solve against
    thomas_dd_reference by phase 3d's rule (1e-5 of the lane's scale,
    pivots within 1e-3), and the fused route by _hold_dd_route."""
    args = _beam_lanes(B, n, 100 * n + B + 9, cuda)
    beam = [args[i] for i in (0, 3, 4, 5, 6)]
    fused, unfused, plain = _dd_routes(beam)
    sys_dd = tsd.assemble_beam_system_dd(*beam, E, A)[:3]
    x, piv = tsd.launch_thomas_streamed_dd(*sys_dd)
    xp, pp = tsd.thomas_dd_reference(*sys_dd)
    torch.cuda.synchronize()
    assert x.shape == (B, n, 3) and piv.shape == (B,)
    assert _lane_err(x, xp) <= 1e-5
    assert ((piv.double() / pp.double() - 1).abs() <= 1e-3).all()
    _hold_dd_route(fused, unfused, plain)


def _overhang_lanes(B, n, seed, device):
    """Span-scaled beams (Le = 2 m) pinned at node 0, rollers every 64
    nodes from node 63 and a 64 m tail overhang, a point load near its end,
    I = 0.05 U(0.8, 1.2): (I, Le, free, loads, udl), float32, and the
    scenario."""
    roller = torch.zeros((B, n), dtype=torch.bool)
    roller[:, 63:n - 32:64] = True
    roller[:, n - 33] = True
    loads = torch.zeros((B, n))
    loads[:, n - 10] = -3.5e5
    sc = BeamScenario(
        node_x=torch.linspace(0.0, 2.0 * (n - 1), n).repeat(B, 1),
        roller_mask=roller, point_loads=loads,
        udl=torch.full((B,), -1000.0)).map(lambda t: t.to(device))
    gen = torch.Generator().manual_seed(seed)
    I = (0.05 * (0.8 + 0.4 * torch.rand((B, n - 1), generator=gen))).to(
        device)
    beam = (I, torch.diff(sc.node_x, dim=-1),
            (~constraint_mask(sc)).float(), sc.point_loads, sc.udl)
    return beam, sc


def _quasi_cantilever_lanes(device):
    """tests/test_beam_kernel_dd.py's four lanes float32 cannot solve: one
    roller 1-5 nodes from the pin, a ~195 m overhang, I a mild ripple."""
    n = 101
    node_x = torch.linspace(0.0, 200.0, n).repeat(4, 1)
    roller = torch.zeros((4, n), dtype=torch.bool)
    loads = torch.zeros((4, n))
    for b, r in enumerate((1, 2, 3, 5)):
        roller[b, r] = True
        loads[b, 60 + 5 * b] = -3.5e5
    sc = BeamScenario(node_x=node_x, roller_mask=roller, point_loads=loads,
                      udl=torch.full((4,), -1000.0))
    I = 0.05 * (0.8 + 0.4 * torch.from_numpy(
        np.random.default_rng(4).random((4, n - 1))).float())
    return [t.to(device) for t in (I, torch.diff(node_x, dim=-1),
                                   (~constraint_mask(sc)).float(), loads,
                                   sc.udl)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_bridge", "quasi_cantilever",
                                  "overhang"])
def test_streamed_dd_fused_route(cuda, case):
    """The fused route on random-bridge lanes (n = 101), on the four
    quasi-cantilever lanes and on span-scaled overhang lanes at n = 1001:
    bitwise the unfused route, within 1e-5 of the plain version's u and
    1e-6 of its pivots, and within 1e-6 of the lane's scale of the float64
    solve of the system assembled by fem.beam."""
    if case == "random_bridge":
        x = _inputs(300, 18, cuda, torch.float32,
                    ScenarioConfig(random_bridge=True))
        beam = [x[k] for k in ("I", "Le", "free", "loads", "udl")]
    elif case == "quasi_cantilever":
        beam = _quasi_cantilever_lanes(cuda)
    else:
        beam = list(_overhang_lanes(64, 1001, 19, cuda)[0])
    fused, unfused, plain = _dd_routes(beam)
    torch.cuda.synchronize()
    _hold_dd_route(fused, unfused, plain)
    assert torch.isfinite(fused[0]).all() and (fused[1] > 0).all()


@pytest.mark.cuda
def test_streamed_dd_non_finite_lanes(cuda):
    """Lanes the system leaves singular or undefined come out non-finite
    where the plain version's do, entry by entry, and in the pivot, in both
    routes: a NaN I, an I = 0 on the first element (a zero diagonal) and
    inside the beam, no support at all.  The other lanes are bitwise those
    of a run without them (lanes are independent)."""
    args = _beam_lanes(70, 101, 21, cuda)
    beam = [args[i] for i in (0, 3, 4, 5, 6)]
    clean = _dd_routes(beam)
    beam[0][5, 40] = float("nan")
    beam[0][9, 0] = 0.0
    beam[0][12, 60] = 0.0
    beam[2][20] = 1.0
    routes = _dd_routes(beam)
    torch.cuda.synchronize()
    assert not torch.isfinite(routes[0][0][5]).any()
    assert torch.isnan(routes[0][1][5])
    fused, unfused, plain = routes
    for route in (fused, unfused):
        for k, p in zip(route, plain):
            assert torch.equal(torch.isfinite(k), torch.isfinite(p))
    keep = torch.ones(70, dtype=torch.bool, device=cuda)
    keep[[5, 9, 12, 20]] = False
    for route, ref in zip(routes[:2], clean[:2]):
        for k, c in zip(route, ref):
            assert torch.equal(k[keep], c[keep])


@pytest.mark.cuda
def test_streamed_dd_rejects_what_it_does_not_take(cuda):
    """#9 reads its inputs as they lie: float32 systems, a transposed view
    and CPU tensors raise in the system launcher; float64, strided or CPU
    beam inputs raise in the fused one; nothing is counted, and no plain
    version runs."""
    args = _beam_lanes(40, 101, 6, cuda)
    beam = [args[i] for i in (0, 3, 4, 5, 6)]
    sys_dd = tsd.assemble_beam_system_dd(*beam, E, A)[:3]
    tsd.reset_counts()
    with pytest.raises(TypeError):
        tsd.launch_thomas_streamed_dd(*(t.float() for t in sys_dd))
    with pytest.raises(TypeError):
        tsd.solve_dd_streamed(*(t.float() for t in sys_dd))
    for i in range(3):
        bad = list(sys_dd)
        bad[i] = sys_dd[i].movedim(0, 1).contiguous().movedim(1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], sys_dd[i])
        with pytest.raises(ValueError, match="contiguous"):
            tsd.solve_dd_streamed(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        tsd.launch_thomas_streamed_dd(*(t.cpu() for t in sys_dd))
    for i in (0, 2):
        bad = list(beam)
        bad[i] = beam[i].movedim(0, -1).contiguous().movedim(-1, 0)
        assert not bad[i].is_contiguous() and torch.equal(bad[i], beam[i])
        with pytest.raises(ValueError, match="contiguous"):
            tsd.solve_beam_dd_streamed(*bad, E, A)
    with pytest.raises(TypeError):
        tsd.solve_beam_dd_streamed(beam[0].double(), *beam[1:], E, A)
    with pytest.raises(ValueError, match="CUDA"):
        tsd.launch_beam_streamed_dd(*(t.cpu() for t in beam), E, A)
    assert not any(tsd.LAUNCHES.values())
    assert not any(tsd.PLAIN_CALLS.values())


@pytest.mark.cuda
def test_solve_beam_checked_large_mesh_streams(cuda):
    """A span-scaled mesh of DD_STREAM_FROM_N nodes (Le = 2 m, rollers
    every 64 nodes, a 64 m tail overhang): the lanes escalate through the
    fused streamed float64 route (#9) on the card, not the float64
    analysis, and no plain version runs."""
    beam, sc = _overhang_lanes(64, tacc.DD_STREAM_FROM_N, 16, cuda)
    I = beam[0]
    mods = (tk, tkd, tbt, tbs, tsd)
    for m in mods:
        m.reset_counts()
    sol, info = solve_beam_checked(I, sc, E, A, tol=1e-4)
    assert info["used_dd"].all()
    assert tsd.LAUNCHES == {"solve_dd_streamed": 0,
                            "solve_beam_dd_streamed": 1}
    assert tkd.LAUNCHES["beam_analysis_dd"] == 0
    for m in mods:
        assert not any(m.PLAIN_CALLS.values()), m.PLAIN_CALLS
    assert sol.deflections.is_cuda and torch.isfinite(sol.deflections).all()
    assert (info["pivot"] > 1e-12).all()
    for m in mods:
        m.reset_counts()


@pytest.mark.cuda
def test_tfd_fit_on_the_card(cuda, monkeypatch):
    """The training path at full width on 2048 generated lanes: features,
    device preprocessing, a two-epoch bfloat16 TFD fit, all on the card,
    every loss finite.  On the trained weights the bfloat16 forward is
    within 0.1 of the output's scale of the float32 forward with the
    diffusion step dropped (the step bfloat16 makes an identity; the same
    tolerance as the CPU test of the two packages' bfloat16 forwards,
    tests/test_torch_tfd.py)."""
    from openpystruct_tpu_torch.data import prepare_dataset_device
    from openpystruct_tpu_torch.datagen import batch_feature_arrays
    from openpystruct_tpu_torch.families import FAMILIES, build_family
    from openpystruct_tpu_torch.models import DiffusionModule
    from openpystruct_tpu_torch.train import fit, predict

    gen = torch.Generator().manual_seed(11)
    arrays = batch_feature_arrays(generate_batch(gen, 2048, device="cuda"))
    cfg = FAMILIES["tfd"].train
    ds = prepare_dataset_device(arrays, n_cases=cfg.n_cases, c=cfg.c,
                                nheads_pad=FAMILIES["tfd"].nheads_pad)
    model, spec, kw = build_family("tfd", ds.feat_dim)
    assert ds.feat_dim == 120 and model.dtype == torch.bfloat16
    res = fit(model, ds.X_train, ds.Y_train, ds.X_val, ds.Y_val,
              dataclasses.replace(spec.train, num_epochs=2), device="cuda",
              **kw)
    assert len(res.val_losses) == 2
    assert np.isfinite(res.train_losses).all()
    assert np.isfinite(res.val_losses).all()
    assert res.params["alpha"].is_cuda
    assert not torch.backends.cuda.matmul.allow_tf32
    m32 = build_family("tfd", ds.feat_dim, compute_dtype="float32")[0]
    y16 = predict(model, res.params, ds.X_val, seed=1)
    monkeypatch.setattr(DiffusionModule, "forward",
                        lambda self, x, generator: x)
    assert torch.equal(y16, predict(model, res.params, ds.X_val, seed=1))
    y32 = predict(m32, res.params, ds.X_val, seed=1)
    assert y16.is_cuda and y16.dtype == torch.float32
    gap = (y16 - y32).abs().max() / y32.abs().max()
    assert gap <= 0.1, gap


@pytest.mark.cuda
def test_shards_resume_and_native_json_on_the_card(cuda, tmp_path):
    """Three random-bridge shards of 256 lanes on the card (#2, #1 and the
    rescue's #8, #7); one deleted and regenerated alone, bitwise; the
    shards through the native writer and reader, every I row the shards'
    valid lanes, bitwise."""
    import os

    from openpystruct_tpu_torch.datagen import (
        generate_to_shards,
        native_available,
        read_json_dataset,
        read_npz_shards,
        reader_available,
        shards_to_json,
    )

    assert native_available() and reader_available()
    opt = dataclasses.replace(DATAGEN_OPT, max_epochs=60)
    kw = dict(batch_size=256, scen_cfg=ScenarioConfig(random_bridge=True),
              opt_cfg=opt, device="cuda")
    shard_dir = str(tmp_path / "shards")
    paths = generate_to_shards(7, 3 * 256, shard_dir, **kw)
    with np.load(paths[1]) as z:
        lost = {k: z[k] for k in z.files}
    os.remove(paths[1])
    tk.reset_counts()
    tkd.reset_counts()
    seen = []
    assert generate_to_shards(7, 3 * 256, shard_dir, on_batch=seen.append,
                              **kw) == paths
    assert len(seen) == 1 and tk.LAUNCHES["beam_analysis"] == 1
    assert tk.LAUNCHES["beam_opt_step"] > 0
    assert not any(tk.PLAIN_CALLS.values())
    assert not any(tkd.PLAIN_CALLS.values())
    with np.load(paths[1]) as z:
        assert set(z.files) == set(lost)
        for k in lost:
            assert z[k].tobytes() == lost[k].tobytes(), k
    path = str(tmp_path / "d.json")
    arrays = read_npz_shards(paths)
    assert shards_to_json(paths, path) == int(arrays["valid"].sum()) > 0
    data = read_json_dataset(path)
    assert data["I_values"].tobytes() == arrays["I"][arrays["valid"]].tobytes()


@pytest.mark.cuda
def test_generate_dataset_json_on_the_card(cuda, tmp_path):
    """The streamed JSON of two 150-lane batches is what generate_dataset
    returns for the same seed."""
    import json

    from openpystruct_tpu_torch.datagen import (
        generate_dataset,
        generate_dataset_json,
    )

    opt = dataclasses.replace(DATAGEN_OPT, max_epochs=60)
    path = tmp_path / "d.json"
    n = generate_dataset_json(4, 300, str(path), batch_size=150,
                              opt_cfg=opt, device="cuda")
    cols = generate_dataset(4, 300, batch_size=150, opt_cfg=opt,
                            device="cuda")
    with open(path) as f:
        assert json.load(f) == cols
    assert n == len(cols["I_values"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fnn", "pinn"])
def test_fnn_pinn_fit_on_the_card(cuda, name):
    """The FNN and the PINN at their published widths in bfloat16 on the
    card: ``fit`` bitwise across ``epochs_per_sync`` (the PINN's BatchNorm
    statistics included), every loss finite, R^2 finite."""
    from openpystruct_tpu_torch.data import Scaler
    from openpystruct_tpu_torch.families import build_family
    from openpystruct_tpu_torch.train import evaluate_r2, fit

    label = 302 if name == "pinn" else 100
    rng = np.random.default_rng(0)
    W = rng.normal(size=(6 * 8, label)) / np.sqrt(6 * 8)
    X = rng.normal(size=(300, 6, 8)).astype(np.float32)
    Y = (X.reshape(300, -1) @ W).astype(np.float32)
    runs = []
    for sync in (1, 3):
        model, spec, kw = build_family(name, 8, label_dim=label)
        cfg = dataclasses.replace(spec.train, num_epochs=4, batch_size=32)
        runs.append(fit(model, X[:240], Y[:240], X[240:], Y[240:], cfg,
                        epochs_per_sync=sync, device="cuda", **kw))
    a, b = runs
    assert np.isfinite(a.train_losses).all()
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    for k, v in a.params["model"].items():
        assert v.is_cuda and torch.equal(v, b.params["model"][k]), k
    assert (name == "pinn") == any("running_" in k for k in a.params["model"])
    scaler = Scaler(mean=np.zeros(label, np.float32),
                    scale=np.ones(label, np.float32))
    r2 = evaluate_r2(model, a.params, X[240:], Y[240:], scaler,
                     label_slice=slice(0, 100), device="cuda")
    assert np.isfinite(r2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gnn", "fno", "bnn", "bnn-meta"])
def test_surrogate_families_fit_on_the_card(cuda, name):
    """The GNN (AdamW), the FNO (float32) and the Bayesian TFDs (the KL
    through ``param_loss_fn``) at their published widths on the card:
    ``fit`` bitwise across ``epochs_per_sync``, every loss finite, TF32
    off, R^2 finite; ``mc_output_stats`` finite with a positive spread."""
    from openpystruct_tpu_torch.data import Scaler
    from openpystruct_tpu_torch.families import build_family
    from openpystruct_tpu_torch.models import mc_output_stats
    from openpystruct_tpu_torch.train import evaluate_r2, fit

    n_cases = 8 if name == "bnn-meta" else 6
    rng = np.random.default_rng(0)
    W = rng.normal(size=(n_cases * 24, 100)) / np.sqrt(n_cases * 24)
    X = rng.normal(size=(300, n_cases, 24)).astype(np.float32)
    Y = (X.reshape(300, -1) @ W).astype(np.float32)
    runs = []
    for sync in (1, 3):
        model, spec, kw = build_family(name, 24)
        cfg = dataclasses.replace(spec.train, num_epochs=4, batch_size=32)
        runs.append(fit(model, X[:240], Y[:240], X[240:], Y[240:], cfg,
                        epochs_per_sync=sync, device="cuda", **kw))
    a, b = runs
    assert not torch.backends.cuda.matmul.allow_tf32
    assert np.isfinite(a.train_losses).all()
    np.testing.assert_array_equal(a.train_losses, b.train_losses)
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    for k, v in a.params["model"].items():
        assert v.is_cuda and torch.equal(v, b.params["model"][k]), k
    scaler = Scaler(mean=np.zeros(100, np.float32),
                    scale=np.ones(100, np.float32))
    r2 = evaluate_r2(model, a.params, X[240:], Y[240:], scaler,
                     device="cuda")
    assert np.isfinite(r2)
    if name.startswith("bnn"):
        mean, std = mc_output_stats(model, a.params, X[240:], n_samples=8,
                                    scaler_Y=scaler, device="cuda")
        assert mean.is_cuda and torch.isfinite(mean).all()
        assert (std > 0).all() and torch.isfinite(std).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,modes,degen", [
    (6, 4, False), (6, 4, True), (8, 4, False), (7, 4, False), (9, 5, True),
    (6, 10, False)])
def test_spectral_conv_on_the_card(cuda, n, modes, degen):
    """The FNO's spectral conv on the card against the numpy complex-FFT
    oracle of tests/test_models.py (even and odd lengths, the Nyquist bin,
    modes past Nyquist, the degenerate mixing), within 1e-5 of scale."""
    from openpystruct_tpu_torch.models import SpectralConv1d

    rng = np.random.default_rng(n * 100 + modes)
    x = rng.normal(size=(3, 5, n)).astype(np.float32)
    conv = SpectralConv1d(5, 5, modes, degenerate_mixing=degen).to(cuda)
    with torch.no_grad():
        y = conv(torch.from_numpy(x).to(cuda)).cpu().numpy()
    wr, wi = (w.detach().cpu().numpy().astype(np.float64)
              for w in (conv.weights_real, conv.weights_imag))
    m_eff = min(modes, n // 2 + 1)
    w = (wr + 1j * wi)[:, :, :m_eff]
    x_ft = np.fft.rfft(x.astype(np.float64), n=n, axis=-1)[:, :, :m_eff]
    if degen:
        out_m = x_ft.sum(axis=1)[:, None, :] * w.sum(axis=1)[None, :, :]
    else:
        out_m = np.einsum("bim,iom->bom", x_ft, w)
    out_ft = np.zeros((3, 5, n // 2 + 1), np.complex128)
    out_ft[:, :, :m_eff] = out_m
    ref = np.fft.irfft(out_ft, n=n, axis=-1)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("nb,ns", [(3, 3), (10, 1), (1, 10), (10, 10),
                                   (20, 20)])
def test_frame_banded_vs_dense_on_the_card(cuda, nb, ns):
    """The banded float32 solve against the dense float64 one on the card
    on healthy lognormal I: per-lane displacement error within 2e-4 of the
    lane's scale at the median and 1e-3 at the worst lane (the JAX
    package's own float32 banded solve reaches a median of 1.0e-4 and
    4.2e-4 at 20x20, 2.6e-4 at 1x10), pivots
    within 1e-3 relative of the float64 banded ones and above the validity
    gate; float64 banded within 1e-10 of dense."""
    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.fem import (
        build_frame,
        solve_frame,
        solve_frame_banded,
    )
    from openpystruct_tpu_torch.fem.frame_banded import FRAME_VALID_PIVOT

    cfg = FrameConfig()
    st = build_frame(nb, ns, cfg, device="cuda")
    gen = torch.Generator().manual_seed(nb * 64 + ns)
    I = (torch.exp(0.5 * torch.randn(64, st.num_elems, generator=gen))
         * cfg.I0).to(cuda)
    sol32, piv32 = solve_frame_banded(I, st, cfg)
    sol64, piv64 = solve_frame_banded(I.double(), st, cfg, torch.float64)
    ref = solve_frame(I.double(), st, cfg, torch.float64, method="dense")
    scale = ref.displacements.flatten(1).abs().amax(1)

    def err(x):
        return ((x.double() - ref.displacements).flatten(1).abs().amax(1)
                / scale)

    assert float(err(sol32.displacements).median()) <= 2e-4
    assert float(err(sol32.displacements).max()) <= 1e-3
    assert float(err(sol64.displacements).max()) <= 1e-10
    assert float(((piv32.double() - piv64).abs() / piv64).max()) <= 1e-3
    assert bool((piv32 > FRAME_VALID_PIVOT).all())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["banded", "dense"])
def test_frame_solve_ignores_caller_tf32_on_the_card(cuda, method):
    """With TF32 asked for by the caller, the frame solve and its gradient
    give the bits of full float32, and the caller's setting is kept."""
    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.fem import build_frame, solve_frame

    cfg = FrameConfig()
    st = build_frame(10, 10, cfg, device="cuda")
    gen = torch.Generator().manual_seed(3)
    I0 = (torch.exp(0.5 * torch.randn(32, st.num_elems, generator=gen))
          * cfg.I0).to(cuda)
    prev = torch.get_float32_matmul_precision()
    out = []
    try:
        for prec in ("highest", "high"):
            torch.set_float32_matmul_precision(prec)
            I = I0.clone().requires_grad_(True)
            sol = solve_frame(I, st, cfg, method=method)
            (sol.end_forces ** 2).sum().backward()
            assert torch.get_float32_matmul_precision() == prec
            out.append((sol.displacements, sol.end_forces, I.grad))
    finally:
        torch.set_float32_matmul_precision(prev)
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_mode", ["semi", "adjoint"])
def test_frame_optimizer_deterministic_on_the_card(cuda, grad_mode):
    """``optimize_frame_batched`` twice on the same inputs: the same bits
    (assembly sums in a fixed order, no atomics); ``chunk_size`` equal in
    value to the whole batch; every I finite and at least the clamp."""
    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.datagen.frames import sample_frame_loads
    from openpystruct_tpu_torch.fem import build_frame
    from openpystruct_tpu_torch.opt import optimize_frame_batched

    cfg = FrameConfig(max_epochs=60)
    st = build_frame(4, 3, cfg, device="cuda")
    udl, lat = sample_frame_loads(torch.Generator().manual_seed(1), 48, cfg,
                                  device="cuda")
    a, b = (optimize_frame_batched(st, udl, lat, cfg, grad_mode=grad_mode)
            for _ in range(2))
    for x, y in ((a.I, b.I), (a.n_epochs, b.n_epochs),
                 (a.solution.end_forces, b.solution.end_forces),
                 (a.loss.total, b.loss.total)):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(a.I).all()) and bool((a.I >= 1e-8).all())
    c = optimize_frame_batched(st, udl, lat, cfg, grad_mode=grad_mode,
                               chunk_size=20)
    assert torch.equal(a.n_epochs, c.n_epochs)
    torch.testing.assert_close(c.I, a.I, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_frame_checked_and_datagen_on_the_card(cuda):
    """``solve_frame_checked`` escalates in float64 on the card and its
    certified lanes are within tol of the float64 dense solve;
    ``generate_frame_dataset`` keeps every row's lengths its topology's."""
    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.datagen import generate_frame_dataset
    from openpystruct_tpu_torch.fem import (
        build_frame,
        solve_frame,
        solve_frame_checked,
    )

    cfg = FrameConfig()
    st = build_frame(3, 4, cfg, device="cuda")
    rng = np.random.default_rng(1)
    I = np.exp(rng.normal(size=(4, st.num_elems)) * 0.5) * cfg.I0
    I[3, rng.choice(st.num_elems, size=int(0.8 * st.num_elems),
                    replace=False)] = 1e-8
    sol, info = solve_frame_checked(torch.tensor(I, dtype=torch.float32,
                                                 device=cuda), st, cfg)
    assert sol.displacements.is_cuda
    np.testing.assert_array_equal(info["used_f64"], [0, 0, 0, 1])
    ref = solve_frame(torch.tensor(I, device=cuda), st, cfg, torch.float64,
                      method="dense").displacements
    err = ((sol.displacements.double() - ref).flatten(1).abs().amax(1)
           / ref.flatten(1).abs().amax(1))
    assert float(err.max()) <= 1e-4 and (info["est"] <= 1e-4).all()

    data = generate_frame_dataset(0, 24, FrameConfig(max_epochs=20),
                                  bays_range=(1, 3), stories_range=(1, 3),
                                  device="cuda")
    assert len(data["I_values"]) == 24
    for i, row in enumerate(data["I_values"]):
        b, s = data["num_bays"][i], data["num_stories"][i]
        assert len(row) == s * (b + 1) + s * b
        assert len(data["displacements"][i]) == (b + 1) * (s + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fnn", "gnn", "bnn"])
def test_fit_resume_on_the_card(cuda, name, tmp_path):
    """``fit`` killed at a sync boundary with ``checkpoint_dir`` and resumed
    with ``resume_from`` equals the uninterrupted run bitwise on the card
    (losses, best epoch, best and final params), for the FNN, the GNN's
    AdamW and ``bnn``'s draws."""
    from openpystruct_tpu_torch.families import build_family
    from openpystruct_tpu_torch.train import fit

    n_cases, feat = 6, 24
    rng = np.random.default_rng(0)
    W = rng.normal(size=(n_cases * feat, 100)) / np.sqrt(n_cases * feat)
    X = rng.normal(size=(200, n_cases, feat)).astype(np.float32)
    Y = (X.reshape(200, -1) @ W).astype(np.float32)
    data = (X[:160], Y[:160], X[160:], Y[160:])

    def run(epochs, **kw):
        model, spec, fit_kw = build_family(name, feat)
        cfg = dataclasses.replace(spec.train, num_epochs=epochs,
                                  batch_size=32)
        return fit(model, *data, cfg, epochs_per_sync=2, device="cuda",
                   **fit_kw, **kw)

    full = run(6)
    run(4, checkpoint_dir=str(tmp_path))
    resumed = run(6, resume_from=str(tmp_path))
    np.testing.assert_array_equal(full.train_losses, resumed.train_losses)
    np.testing.assert_array_equal(full.val_losses, resumed.val_losses)
    assert full.best_epoch == resumed.best_epoch
    for res_a, res_b in ((full.params, resumed.params),
                         (full.state["params"], resumed.state["params"])):
        for k, v in res_a["model"].items():
            assert torch.equal(v, res_b["model"][k]), k
        assert torch.equal(res_a["alpha"], res_b["alpha"])


@pytest.mark.cuda
def test_frame_checked_clamp_batch_on_the_card(cuda):
    """On the clamp batch (3x4, 70-95% of the members at 1e-8,
    ``default_rng(11)``), every lane ``solve_frame_checked`` leaves in
    float32 lies above the pivot floor and within 10 x tol of float64."""
    from openpystruct_tpu_torch.config import FrameConfig
    from openpystruct_tpu_torch.fem import (
        build_frame,
        solve_frame,
        solve_frame_checked,
    )
    from openpystruct_tpu_torch.fem.frame_banded import FRAME_VALID_PIVOT

    cfg = FrameConfig()
    st = build_frame(3, 4, cfg, device="cuda")
    E, B = st.num_elems, 2048
    rng = np.random.default_rng(11)
    I = np.exp(rng.normal(size=(B, E)) * 0.5) * cfg.I0
    for k in range(B):
        frac = 0.7 + 0.25 * rng.random()
        I[k, rng.choice(E, size=int(frac * E), replace=False)] = 1e-8
    I = torch.tensor(I.astype(np.float32), device=cuda)
    with warnings.catch_warnings():     # lanes float64 cannot certify
        warnings.simplefilter("ignore", RuntimeWarning)
        sol, info = solve_frame_checked(I, st, cfg, tol=1e-4)
    ref = solve_frame(I.double(), st, cfg, torch.float64,
                      method="dense").displacements
    err = ((sol.displacements.double() - ref).flatten(1).abs().amax(1)
           / ref.flatten(1).abs().amax(1)).cpu().numpy()
    kept = ~info["used_f64"]
    assert kept.any() and info["used_f64"].any()
    assert (info["pivot"][kept] >= FRAME_VALID_PIVOT).all()
    assert err[kept].max() <= 1e-3


@pytest.mark.cuda
def test_cli_and_bench_on_the_card(cuda, capsys):
    """The CLI runs on the card by default; the bench's device functions
    launch the analysis (#1) and the opt-step (#2) kernels."""
    from openpystruct_tpu_torch import bench, cli

    hist = cli.main(["beam-opt", "--epochs", "3", "--refine", "0"])
    assert hist.shape == (3, 4) and np.isfinite(hist).all()
    assert "Total Loss:" in capsys.readouterr().out
    I = np.full(100, 0.5, np.float32)
    sc, *_ = bench.build_system(I)
    tk.reset_counts()
    best, median = bench.device_rate(sc, I, batch=64, reps=10, chain=2)
    rate = bench.beamopt_iters_rate(sc, I, batch=64, iters=3)
    assert best >= median > 0 and rate > 0
    assert tk.LAUNCHES["beam_analysis"] == 2 * (1 + 5)
    assert tk.LAUNCHES["beam_opt_step"] == 3 * 4
    assert tk.PLAIN_CALLS["beam_analysis"] == 0


@pytest.mark.cuda
def test_profile_trace_names_the_kernel_on_the_card(cuda, tmp_path):
    import json

    from openpystruct_tpu_torch.utils import profile_trace

    I = np.full(100, 0.5, np.float32)
    from openpystruct_tpu_torch import bench

    sc, *_ = bench.build_system(I)
    with profile_trace(str(tmp_path)) as prof:
        bench.device_rate(sc, I, batch=64, reps=1, chain=1)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("beam_analysis_kernel" in k for k in kernels), kernels[:5]


@pytest.mark.cuda
def test_distribution_on_the_card(cuda, tmp_path):
    """A NCCL group of one rank on the card: ``generate_batch(mesh=)`` on
    a random-bridge batch (the float64 rescue's kernels included) bitwise
    the run without a mesh, launching the kernels, and
    ``all_processes_min_max`` on the card."""
    import torch.distributed as dist

    from openpystruct_tpu_torch import parallel

    parallel.initialize_multihost(init_method=f"file://{tmp_path / 'store'}",
                                  world_size=1, rank=0)
    try:
        mesh = parallel.default_mesh()
        assert dist.get_backend(mesh.group) == "nccl"
        assert mesh.device == torch.device("cuda", 0)
        cfg = ScenarioConfig(random_bridge=True)
        want = generate_batch(torch.Generator().manual_seed(9), 2048, cfg)
        tk.reset_counts()
        tkd.reset_counts()
        got = generate_batch(torch.Generator().manual_seed(9), 2048, cfg,
                             mesh=mesh)
        assert all(tk.LAUNCHES[k] for k in ("beam_analysis",
                                            "beam_opt_step"))
        assert all(tkd.LAUNCHES.values())
        for name in ("I", "I_solved", "n_epochs", "pivot"):
            assert torch.equal(getattr(got.result, name),
                               getattr(want.result, name)), name
        assert torch.equal(got.valid, want.valid)
        lo, hi = parallel.all_processes_min_max(want.result.I)
        assert lo.is_cuda and torch.equal(hi, want.result.I.max())
    finally:
        dist.destroy_process_group()
