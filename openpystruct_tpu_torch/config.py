"""Configuration dataclasses (copies of ``openpystruct_tpu.config``).

The port keeps its own copies so that it never imports the JAX package;
``tests/test_torch_config.py`` holds them field by field against the JAX
originals.  Defaults are the reference's values
(OpenPyStruct_BeamOpt.py:24-48, OpenPyStruct_BeamOpt_training_MultiCore.py:20-70).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Physical beam setup (reference OpenPyStruct_BeamOpt.py:24-37)."""

    E: float = 200e9          # Young's modulus (Pa)
    nu: float = 0.3           # Poisson ratio
    A: float = 0.01           # cross-sectional area (m^2)
    L: float = 200.0          # beam length (m)
    num_nodes: int = 101      # nodes along the beam
    I0: float = 0.5           # initial moment-of-inertia guess (m^4)
    udl: float = -5000.0      # uniformly distributed load (N/m); datagen uses -1000

    @property
    def G(self) -> float:
        """Shear modulus (reference OpenPyStruct_BeamOpt.py:26)."""
        return self.E / (2.0 * (1.0 + self.nu))

    @property
    def num_elements(self) -> int:
        return self.num_nodes - 1


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """I-field optimization loop (reference OpenPyStruct_BeamOpt.py:40-48).

    ``grad_mode`` is "semi" (the reference: element forces are constants
    each iteration, OpenPyStruct_BeamOpt.py:150-151) or "adjoint" (the exact
    implicit-differentiation gradient through the FE solve).
    """

    max_epochs: int = 1000
    lr: float = 0.01
    lr_gamma: float = 0.98           # ExponentialLR decay per epoch
    alpha_moment: float = 1e-2
    alpha_shear: float = 1e-2
    tolerance: float = 1e-2          # minimum loss improvement
    patience: int = 10               # epochs without improvement before stop
    clamp_min: float = 1e-8          # post-step lower clamp on I
    grad_mode: str = "semi"          # "semi" (reference) | "adjoint" (exact)


#: Optimization budget used by the data generators
#: (reference OpenPyStruct_BeamOpt_training_MultiCore.py:36-44).
DATAGEN_OPT = OptimizerConfig(max_epochs=600, tolerance=5e-3, patience=5)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Random load/support scenario distribution
    (reference OpenPyStruct_BeamOpt_training_MultiCore.py:20-70,136-162)."""

    num_nodes: int = 101
    n_rollers_max: int = 4
    m_forces_max: int = 4
    L_max: float = 200.0
    L_min: float = 15.0               # also min roller spacing in BeamOpt
    max_force: float = -355857.0      # N (80,000 lb semi)
    udl: float = -1000.0              # datagen UDL (N/m)
    random_bridge: bool = False       # randomize length + roller layout
    # Fixed bridge roller node tags (1-based, OpenSees convention;
    # reference MultiCore.py:66).
    fixed_roller_tags: tuple = (10, 30, 70, 85, 100)
    # Store roller/force locations in random DRAW order like the reference
    # (MultiCore.py:137-162) rather than ascending node order.  Affects
    # dataset feature ordering only, never the physics.
    store_draw_order: bool = True

    @property
    def min_force(self) -> float:
        return self.max_force / 10.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Shared surrogate-training knobs (reference OpenPyStruct_FNN_MultiCase.py:35-51)."""

    n_cases: int = 6
    nelem: int = 100
    box_constraint_coeff: float = 5e-1
    hidden_units: int = 128
    dropout_rate: float = 0.5
    num_epochs: int = 500
    batch_size: int = 128
    patience: int = 10
    learning_rate: float = 2e-4
    weight_decay: float = 1e-2
    train_split: float = 0.8
    sigma_0: float = 0.03            # initial Gaussian input-noise level
    gamma_noise: float = 0.97        # per-epoch noise decay
    lr_gamma: float = 0.99           # ExponentialLR decay
    initial_alpha: float = 0.5       # initial L1/L2 blend
    c: float = 1.0                   # label aggregation: mean + c*std
    seed: int = 0
    compute_dtype: str = "bfloat16"  # matmul/compute precision (AMP analog)


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """2D frame setup (reference OpenPyStruct_FrameOpt_Discrete_Beta.py:17-44)."""

    E: float = 200e9          # FrameOpt_Discrete_Beta.py:26
    nu: float = 0.3           # :27
    A: float = 0.02           # :29
    bay_width: float = 6.0    # :22
    story_height: float = 3.0  # :23
    num_bays: int = 3          # randomized 1..10 in the reference (:50-52)
    num_stories: int = 3       # randomized 1..10 in the reference (:50-52)
    I0: float = 5e-4          # :30
    udl: float = -1e4         # vertical_load, :38
    lateral_load: float = 1e4  # :37
    lr: float = 0.005         # :42
    max_epochs: int = 5000    # :41
    tolerance: float = 1e-3   # :43
    patience: int = 10        # :44

    @property
    def G(self) -> float:
        return self.E / (2.0 * (1.0 + self.nu))
