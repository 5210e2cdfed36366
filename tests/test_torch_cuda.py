"""Port, on the card only: each CUDA kernel against its plain version.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.  ``chip_smoke.py`` runs the same
checks at full width (B = 16384).
"""

import pytest
import torch

from openpystruct_tpu_torch.config import DATAGEN_OPT, BeamConfig
from openpystruct_tpu_torch.datagen import run_batch, sample_scenarios
from openpystruct_tpu_torch.fem.beam import constraint_mask
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.opt import beam_opt

BEAM = BeamConfig(udl=-1000.0)
E, A, G = BEAM.E, BEAM.A, BEAM.G


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, seed, device, dtype):
    gen = torch.Generator().manual_seed(seed)
    sc = sample_scenarios(gen, B, device="cpu", dtype=torch.float64)
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


def _hold(kern, f64, f32):
    """Kernel error vs plain float64 no more than twice the plain float32
    version's, or 1e-5 of the output's scale."""
    for k, t64, p32 in zip(kern, f64, f32):
        scale = t64.abs().max().item()
        err_k = (k.double() - t64).abs().max().item() / scale
        err_p = (p32.double() - t64).abs().max().item() / scale
        assert err_k <= max(2 * err_p, 1e-5), (err_k, err_p)


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
    with pytest.raises(NotImplementedError):
        from openpystruct_tpu_torch.fem.beam import solve_beam_batched

        sc = sample_scenarios(torch.Generator().manual_seed(0), 2,
                              device=cuda)
        solve_beam_batched(torch.full((2, 100), 0.5, device=cuda), sc, E, A)


@pytest.mark.cuda
def test_batch_program_launches_kernels_only(cuda):
    sc = sample_scenarios(torch.Generator().manual_seed(4), 256,
                          device=cuda)
    tk.reset_counts()
    batch = run_batch(sc, BEAM, DATAGEN_OPT)
    assert tk.PLAIN_CALLS == {"beam_analysis": 0, "beam_opt_step": 0}
    assert tk.LAUNCHES["beam_analysis"] == 1
    # the done flags are read every _SYNC_EVERY epochs: up to 3 epochs run
    # on frozen lanes after the last one converged
    extra = tk.LAUNCHES["beam_opt_step"] - int(batch.result.n_epochs.max())
    assert 0 <= extra < beam_opt._SYNC_EVERY
    assert batch.valid.all()
    tk.reset_counts()
