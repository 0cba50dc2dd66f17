"""The benchmark's plain reference of the registration step.

Frozen copies of the port's plain PyTorch versions, kept here so that no
later change to the program moves the yardstick: ``pre_downsample`` and
``register_batch`` run the whole main path (the voxel-grid downsample,
the fused voxelization, faces, hypotheses, clusters, quick verify, the
LM refinement, fine verify and fusion) with every kernel of the port
replaced by its plain version, on whatever device the inputs are on.
The module docstrings describe the originals; here no path launches a
kernel of the port. Nothing here imports the program. ``precision``
holds the TF32 control (``tf32_products``)."""

from .config import Capacities, FCCFParams
from .precision import tf32_products, tf32_round
from .register import RegistrationResult, pre_downsample, register_batch

__all__ = ["Capacities", "FCCFParams", "RegistrationResult", "pre_downsample",
           "register_batch", "tf32_products", "tf32_round"]
