"""Port: the copied configs equal the JAX package's, field by field."""

import dataclasses

import pytest

from openpystruct_tpu import config as jax_config
from openpystruct_tpu_torch import config as torch_config


@pytest.mark.parametrize("name", ["BeamConfig", "OptimizerConfig",
                                  "ScenarioConfig", "TrainConfig"])
def test_config_fields_match(name):
    j, t = getattr(jax_config, name), getattr(torch_config, name)
    fj = [(f.name, f.default) for f in dataclasses.fields(j)]
    ft = [(f.name, f.default) for f in dataclasses.fields(t)]
    assert ft == fj
    assert t.__dataclass_params__.frozen


@pytest.mark.parametrize("prop,cls", [("G", "BeamConfig"),
                                      ("num_elements", "BeamConfig"),
                                      ("min_force", "ScenarioConfig")])
def test_config_properties_match(prop, cls):
    j, t = getattr(jax_config, cls)(), getattr(torch_config, cls)()
    assert getattr(t, prop) == getattr(j, prop)


def test_datagen_opt_matches():
    assert (dataclasses.asdict(torch_config.DATAGEN_OPT)
            == dataclasses.asdict(jax_config.DATAGEN_OPT))
