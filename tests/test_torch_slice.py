"""Port: the fixed-bridge datagen slice end to end on the CPU in float64 —
two tiny batches, generate -> 13-key JSON -> read back — and the entry
points' refusals."""

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
from openpystruct_tpu_torch.ops import beam_kernel as tk

FAST = OptimizerConfig(max_epochs=20, tolerance=5e-3, patience=5)


def test_slice_end_to_end_cpu_f64(tmp_path):
    seen = []
    tk.reset_counts()
    cols = generate_dataset(0, 10, batch_size=5, opt_cfg=FAST, device="cpu",
                            dtype=torch.float64, on_batch=seen.append)
    assert len(seen) == 2
    assert tk.LAUNCHES == {"beam_analysis": 0, "beam_opt_step": 0}
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
    back = read_json_dataset(path)
    assert set(back) == set(SCHEMA_KEYS)
    assert all(len(back[k]) == n_valid for k in SCHEMA_KEYS)
    I = np.asarray(back["I_values"])
    assert I.shape == (10, 100) and np.isfinite(I).all()
    np.testing.assert_array_equal(
        I, np.concatenate([b.result.I.numpy() for b in seen]))
    assert back["num_nodes"] == [101] * 10 and back["L"] == [200.0] * 10
    tk.reset_counts()


def test_entry_points_refuse_what_is_not_ported():
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(scen_cfg=ScenarioConfig(random_bridge=True)),
               dict(scen_cfg=ScenarioConfig(num_nodes=201)),
               dict(rescue="dd")):
        with pytest.raises(NotImplementedError):
            generate_batch(gen, 4, device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            generate_dataset(0, 4, device="cpu", **kw)


def test_default_device_is_cuda():
    """With no card, the default device raises instead of running on the
    CPU; on a card the same call is the kernel path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        generate_batch(torch.Generator().manual_seed(0), 4, opt_cfg=FAST)
