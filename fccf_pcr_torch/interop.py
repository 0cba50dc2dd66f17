"""State carried across between the JAX reference and the port.

FCCF has no learned weights: its "weights" are the configuration, and its
state is each stage's NamedTuple output. This module converts both, so a
test can feed one JAX stage's outputs into the port's next stage:

  - ``params_from_reference`` / ``caps_from_reference`` take
    ``dataclasses.asdict`` of the JAX ``FCCFParams`` / ``Capacities``;
  - ``from_numpy`` builds a port NamedTuple from numpy arrays (or from any
    NamedTuple / mapping of array-likes) on a device;
  - ``to_numpy`` turns a port NamedTuple back into numpy arrays.

Dtypes: float32, int32 and bool carry over unchanged. uint32 (the JAX
fine-verify voxel keys) becomes int64, which holds every uint32 value
with the same order — torch has no sortable uint32 on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Capacities, FCCFParams

# JAX-only fields with no counterpart in the port.
_DROPPED_PARAMS = ("use_pallas",)


def params_from_reference(d: dict) -> FCCFParams:
    """Port FCCFParams from ``dataclasses.asdict`` of the JAX object."""
    names = {f.name for f in dataclasses.fields(FCCFParams)}
    extra = set(d) - names - set(_DROPPED_PARAMS)
    if extra:
        raise ValueError(f"unknown FCCFParams fields: {sorted(extra)}")
    return FCCFParams(**{k: v for k, v in d.items() if k in names})


def caps_from_reference(d: dict) -> Capacities:
    """Port Capacities from ``dataclasses.asdict`` of the JAX object."""
    return Capacities(**d)


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_numpy(cls, arrays, device="cpu"):
    """``cls(**fields)`` with every field converted to a tensor on
    ``device``. ``arrays`` is a NamedTuple or a mapping by field name."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    return cls(**{f: _to_tensor(arrays[f], device) for f in cls._fields})


def to_numpy(nt):
    """A NamedTuple of tensors -> a dict of numpy arrays by field name."""
    return {
        f: v.detach().cpu().numpy() for f, v in zip(nt._fields, nt)
    }
