"""The plain reference: its frozen sampler draws the port's scenarios bit
for bit, its optimizer follows the port's plain CPU path in float64, and
its adjoint gradient is autograd's."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import registry  # noqa: E402
from portbench.reference import beam as rb  # noqa: E402
from portbench.reference import judge as rj  # noqa: E402
from portbench.reference import sampler  # noqa: E402

SEED = 2**31 + 12345


def _scen(bridge, n=None):
    """The configuration's scenario, its fixed bridge or, as the command
    line's ``--random-bridge`` draws them, random bridges."""
    cfg = dict(registry.load_json("configs", "bridge-n101")["scenario"],
               random_bridge=bridge == "random")
    if n is not None:
        cfg = dict(cfg, num_nodes=n,
                   fixed_roller_tags=[t for t in cfg["fixed_roller_tags"]
                                      if t < n])
    return cfg


def _port_cfg(cfg):
    from openpystruct_tpu_torch.config import ScenarioConfig

    return ScenarioConfig(**dict(cfg, fixed_roller_tags=tuple(
        cfg["fixed_roller_tags"])))


@pytest.mark.parametrize("config", ["fixed", "random"])
def test_sampler_draws_the_ports_scenarios_bitwise(config):
    from openpystruct_tpu_torch.datagen.sampler import sample_scenarios

    cfg = _scen(config)
    g1, g2 = (torch.Generator().manual_seed(SEED) for _ in range(2))
    rows = [3, 17, 100, 255]
    for batch in range(3):      # the generator carried across batches
        sc = sample_scenarios(g1, 256, _port_cfg(cfg), device="cpu")
        ref = sampler.draw(g2, 256, cfg, rows=None if batch != 1 else rows)
        sel = slice(None) if batch != 1 else rows
        for k in rj.SCENARIO_FIELDS:
            mine = np.asarray(ref[k])
            if mine.dtype == np.float64:
                mine = mine.astype(np.float32)
            np.testing.assert_array_equal(getattr(sc, k).numpy()[sel], mine)


@pytest.mark.parametrize("mode", ["semi", "adjoint"])
@pytest.mark.parametrize("config", ["fixed", "random"])
def test_reference_follows_the_ports_plain_path_in_float64(config, mode):
    """8 lanes at n = 21 over 20 epochs: the port's fused optimizer on CPU
    float64 tensors runs the kernels' plain versions."""
    from openpystruct_tpu_torch.config import BeamConfig, OptimizerConfig
    from openpystruct_tpu_torch.datagen.sampler import sample_scenarios
    from openpystruct_tpu_torch.opt.beam_opt import optimize_beam_batched

    full = registry.load_json("configs", "bridge-n101")
    cfg = _scen(config, n=21)
    opt = dict(full["optimizer"], max_epochs=20, grad_mode=mode)
    sc = sample_scenarios(torch.Generator().manual_seed(SEED), 8,
                          _port_cfg(cfg), device="cpu")
    res = optimize_beam_batched(
        sc.map(lambda x: x.double() if x.is_floating_point() else x),
        BeamConfig(udl=cfg["udl"]), OptimizerConfig(**opt), refine=1)
    ref_sc = rj.replay(SEED, dict(full, scenario=cfg), 8, [np.arange(8)])
    bm = rb.make_beams(ref_sc, full["beam"], torch.float64, "cpu")
    ar = rb.Arith("f64")
    ref = rb.optimize(bm, opt, full["beam"]["I0"], ar)
    u, V, M, piv = rb.analysis(ref.I_solved, bm, ar)
    assert torch.equal(res.n_epochs.long(), ref.n_epochs)
    for a, b in ((res.I, ref.I), (res.I_solved, ref.I_solved),
                 (res.solution.displacements, u),
                 (res.solution.bending_moments, M),
                 (res.solution.shear_forces, V), (res.loss.total, ref.loss),
                 (res.pivot, piv)):
        scale = b.abs().amax()
        assert float((a - b).abs().amax() / scale) < 1e-9


def test_adjoint_gradient_is_autograds():
    cfg = _scen("random", n=15)
    full = registry.load_json("configs", "bridge-n101")
    sc = sampler.draw(torch.Generator().manual_seed(SEED), 4, cfg)
    bm = rb.make_beams(sc, full["beam"], torch.float64, "cpu")
    ar = rb.Arith("f64")
    opt = dict(full["optimizer"], grad_mode="adjoint")
    I = (0.1 + torch.rand((4, 14), generator=torch.Generator().manual_seed(1),
                          dtype=torch.float64)).requires_grad_(True)
    _, V, M, _ = rb.analysis(I, bm, ar, with_pivot=False)
    total = rb.loss_terms(I, V, M, bm, opt)[0]
    (auto,) = torch.autograd.grad(total.sum(), I)
    scale = auto.abs().amax(-1)
    _, g = rb.gradient(I.detach(), bm, opt, ar)
    assert float(((g - auto).abs().amax(-1) / scale).max()) < 1e-9
    # the semi gradient is another one: M and V held constant
    _, gs = rb.gradient(I.detach(), bm, dict(opt, grad_mode="semi"), ar)
    assert float(((gs - auto).abs().amax(-1) / scale).max()) > 1e-2


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, 3.0],
                     dtype=torch.float32)
    y = rb._tf32(x)
    assert y.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 3.0]
    m = y.view(torch.int32) & 0x1FFF
    assert int(m.abs().sum()) == 0
