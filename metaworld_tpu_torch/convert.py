"""State converter between the JAX package's trees and the port's containers.

The JAX side hands its trees over as nested dicts of numpy arrays (`as_dict`
makes one from any dataclass tree, the JAX package's flax structs
included, without importing JAX); the `*_from_dict` functions build the
port's containers from such dicts on a device, and `as_dict` turns the
port's containers back into dicts. Fields the port does not keep are
dropped on the way in: `EnvState.rng` and the fused state's `key` (the
port draws from `torch.Generator`s instead). The scripted experts
(`policies`) have no parameters, so nothing is carried for them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metaworld_tpu_torch.types import EnvState, SceneParams, SimState

_DROP = ("rng", "key")


def as_dict(tree) -> dict:
    """Nested dict of numpy arrays from a dataclass tree (either package)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: as_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.name not in _DROP}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = np.bool_
    elif a.dtype.kind in "iu":
        dt = np.int32
    else:
        dt = np.float32
    return torch.from_numpy(np.array(a, dtype=dt)).to(device)


def _build(cls, d: dict, device, nested=None):
    kw = {}
    for f in dataclasses.fields(cls):
        if nested and f.name in nested:
            kw[f.name] = _build(nested[f.name], d[f.name], device, nested)
        else:
            kw[f.name] = _tensor(d[f.name], device)
    return cls(**kw)


def scene_from_dict(d: dict) -> SceneParams:
    """Scene row as the port builds it: numpy, dtypes unchanged."""
    return SceneParams(**{f.name: np.asarray(d[f.name])
                          for f in dataclasses.fields(SceneParams)})


def sim_from_dict(d: dict, device="cuda") -> SimState:
    return _build(SimState, d, device)


def env_from_dict(d: dict, device="cuda") -> EnvState:
    return _build(EnvState, d, device, nested={"sim": SimState})


def fused_from_dict(d: dict, device="cuda"):
    """The fused engine's state (see vector.FusedState)."""
    from metaworld_tpu_torch.vector import FusedState

    return _build(FusedState, d, device,
                  nested={"env": EnvState, "sim": SimState})
