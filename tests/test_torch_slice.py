"""Port: the datagen slices end to end on the CPU — fixed-bridge batches in
float64, generate -> 13-key JSON -> read back; random-bridge and 201-node
batches with the rescue — and the default device."""

import numpy as np
import pytest
import torch

from openpystruct_tpu_torch.config import OptimizerConfig, ScenarioConfig
from openpystruct_tpu_torch.datagen import (
    SCHEMA_KEYS,
    generate_batch,
    generate_dataset,
    read_json_dataset,
    write_json_dataset,
)
from openpystruct_tpu_torch.datagen.generate import (
    RESCUE_PIVOT_TOL,
    _resolve_rescue,
)
from openpystruct_tpu_torch.ops import beam_kernel as tk
from openpystruct_tpu_torch.ops import beam_kernel_dd as tkd

FAST = OptimizerConfig(max_epochs=20, tolerance=5e-3, patience=5)


def test_slice_end_to_end_cpu_f64(tmp_path):
    seen = []
    tk.reset_counts()
    cols = generate_dataset(0, 10, batch_size=5, opt_cfg=FAST, device="cpu",
                            dtype=torch.float64, on_batch=seen.append)
    assert len(seen) == 2
    assert tk.LAUNCHES == {"beam_analysis": 0, "beam_opt_step": 0,
                           "beam_solve": 0}
    assert tk.PLAIN_CALLS["beam_analysis"] == 2
    assert tk.PLAIN_CALLS["beam_opt_step"] == sum(
        int(b.result.n_epochs.max()) for b in seen)
    n_valid = sum(int(b.valid.sum()) for b in seen)
    assert n_valid == 10
    for b in seen:
        res = b.result
        assert res.I.dtype == torch.float64
        assert (res.I >= FAST.clamp_min).all()
        # no deflection at the pin and the rollers; u_x == 0 exactly
        assert (res.solution.deflections[:, 0] == 0).all()
        assert (res.solution.deflections[b.scenario.roller_mask] == 0).all()
        assert (res.solution.displacements[..., 0] == 0).all()
        assert (b.residual > 1e-9).all()

    path = str(tmp_path / "data.json")
    write_json_dataset(cols, path)
    back = read_json_dataset(path, native=False)
    assert set(back) == set(SCHEMA_KEYS)
    assert all(len(back[k]) == n_valid for k in SCHEMA_KEYS)
    I = np.asarray(back["I_values"])
    assert I.shape == (10, 100) and np.isfinite(I).all()
    np.testing.assert_array_equal(
        I, np.concatenate([b.result.I.numpy() for b in seen]))
    assert back["num_nodes"] == [101] * 10 and back["L"] == [200.0] * 10
    tk.reset_counts()


def test_entry_points_refuse_what_is_not_ported():
    """Random-bridge, 201-node and rescue="dd" datagen, which this slice's
    entry points once refused, now run the rescue on the CPU (float32, as
    the card runs it): every lane kept, the float32-kept lanes untouched,
    rescued lanes pinned at their supports; "dd" runs the float64 kernels'
    plain versions, the CPU default "f64" the host split path."""
    cases = ((dict(scen_cfg=ScenarioConfig(random_bridge=True)), "f64"),
             (dict(scen_cfg=ScenarioConfig(num_nodes=201)), "f64"),
             (dict(scen_cfg=ScenarioConfig(random_bridge=True), rescue="dd"),
              "dd"))
    for kw, mode in cases:
        first = generate_batch(torch.Generator().manual_seed(1), 6,
                               opt_cfg=FAST, device="cpu",
                               **dict(kw, rescue=False))
        assert not first.valid.all(), "seed produced no float32 drops"
        tkd.reset_counts()
        b = generate_batch(torch.Generator().manual_seed(1), 6, opt_cfg=FAST,
                           device="cpu", **kw)
        assert (tkd.PLAIN_CALLS["beam_opt_step_dd"] > 0) == (mode == "dd")
        assert b.valid.all()
        kept = first.valid
        assert torch.equal(b.result.I[kept], first.result.I[kept])
        resc = b.valid & ~kept
        defl = b.result.solution.deflections[resc]
        assert (defl[:, 0] == 0).all()
        assert (defl[b.scenario.roller_mask[resc]] == 0).all()
        assert (b.residual[resc] > RESCUE_PIVOT_TOL).all()
        cols = generate_dataset(1, 6, batch_size=3, opt_cfg=FAST,
                                device="cpu", **kw)
        assert len(cols["I_values"]) == 6
    tkd.reset_counts()
    with pytest.raises(ValueError):
        generate_batch(torch.Generator().manual_seed(1), 4, opt_cfg=FAST,
                       device="cpu", rescue="f128")


RB, FINE = ScenarioConfig(random_bridge=True), ScenarioConfig(num_nodes=201)


@pytest.mark.parametrize("rescue, scen, grad_mode, device, want", [
    (None, ScenarioConfig(), "semi", "cuda", False),
    (None, RB, "semi", "cpu", "f64"),
    (None, RB, "semi", "cuda", "dd"),
    (None, FINE, "semi", "cuda", "dd"),
    (True, ScenarioConfig(), "semi", "cpu", "f64"),
    ("f64", RB, "semi", "cuda", "f64"),
    (None, RB, "adjoint", "cpu", "f64"),
    ("f64", RB, "adjoint", "cuda", "f64"),
    (False, RB, "adjoint", "cuda", False),
    (None, RB, "adjoint", "cuda", NotImplementedError),
    ("dd", FINE, "adjoint", "cuda", NotImplementedError),
    (True, ScenarioConfig(), "adjoint", "cuda", NotImplementedError),
])
def test_rescue_resolution(rescue, scen, grad_mode, device, want):
    """generate_batch's rescue argument: the float64 kernels by default on
    a CUDA batch, the host float64 path by default on the CPU, and no
    silent move of a CUDA batch's adjoint rescue to the host."""
    dev = torch.device(device)
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="beam_opt_step_dd"):
            _resolve_rescue(rescue, scen, grad_mode, dev)
    else:
        assert _resolve_rescue(rescue, scen, grad_mode, dev) == want


def test_random_bridge_json_round_trip(tmp_path):
    """Random-bridge samples through the 13-key JSON: L and the node
    positions per lane, rescued lanes included."""
    cols = generate_dataset(3, 8, batch_size=4, opt_cfg=FAST, device="cpu",
                            scen_cfg=ScenarioConfig(random_bridge=True))
    path = str(tmp_path / "rb.json")
    write_json_dataset(cols, path)
    back = read_json_dataset(path, native=False)
    assert back == cols and len(back["L"]) == 8
    assert len(set(back["L"])) == 8
    for L, x, rollers, nodes in zip(back["L"], back["node_positions"],
                                    back["roller_x_locations"],
                                    back["roller_nodes"]):
        assert L == x[-1] and 15.0 <= L <= 215.0 and len(x) == 101
        assert 1 <= len(nodes) <= 4
        assert rollers == [x[t - 1] for t in nodes]


def test_default_device_is_cuda():
    """With no card, the default device raises instead of running on the
    CPU; on a card the same call is the kernel path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        generate_batch(torch.Generator().manual_seed(0), 4, opt_cfg=FAST)
