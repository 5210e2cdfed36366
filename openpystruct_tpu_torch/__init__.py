"""PyTorch + CUDA port of ``openpystruct_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package never imports JAX or
``openpystruct_tpu``.  Its module names mirror the JAX package's.  Every
Pallas kernel on a ported path is a CUDA kernel written by hand for sm_90a
(``ops/csrc``), built with ``nvcc`` at first use; beside each kernel stands a
plain PyTorch version that CPU tensors run.
"""

from openpystruct_tpu_torch.config import (  # noqa: F401
    DATAGEN_OPT,
    BeamConfig,
    OptimizerConfig,
    ScenarioConfig,
    TrainConfig,
)
