"""fccf_pcr_torch — the PyTorch / CUDA port of fccf_pcr_tpu.

Feature-consistent coplane-pair correspondence- and fusion-based rigid
registration (FCCF-PCR), on PyTorch tensors, with the label-propagation
sweep as a hand-written CUDA kernel for Hopper. The JAX package
``fccf_pcr_tpu`` is the reference it is tested against; this package
imports neither jax nor ``fccf_pcr_tpu``.

Public API (the same names as ``fccf_pcr_tpu``):
    FCCFParams, Capacities          — static configuration
    register_pair, make_register_fn — single/batched registration
    pre_downsample                  — CLI-level first VoxelGrid pass
    registration_errors             — RRE/RTE metrics
"""

from .config import Capacities, FCCFParams, TEST_CAPS
from .pipeline.metrics import registration_errors
from .pipeline.register import (
    RegistrationResult,
    make_register_fn,
    pre_downsample,
    register_pair,
)

__version__ = "0.1.0"

__all__ = [
    "Capacities",
    "FCCFParams",
    "TEST_CAPS",
    "RegistrationResult",
    "make_register_fn",
    "pre_downsample",
    "register_pair",
    "registration_errors",
    "__version__",
]
