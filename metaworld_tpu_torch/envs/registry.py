"""Task registry: name -> TaskSpec, in the reference's canonical order.

The ordering below must match the reference's ALL_V3_ENVIRONMENTS
(ref metaworld/env_dict.py:217-270) — one-hot task IDs, benchmark splits and
checkpoint layouts all key off this order.

Copied from the JAX package's `envs/registry.py`; all 50 task modules are
ported.

Task modules register themselves lazily: each module in
metaworld_tpu_torch/envs/tasks/ calls `register(name)(make_spec)` at import.
"""

from __future__ import annotations

import importlib
from typing import Callable

from metaworld_tpu_torch.envs.core import TaskSpec

ALL_V3_ENVIRONMENTS = [
    "assembly-v3",
    "basketball-v3",
    "bin-picking-v3",
    "box-close-v3",
    "button-press-topdown-v3",
    "button-press-topdown-wall-v3",
    "button-press-v3",
    "button-press-wall-v3",
    "coffee-button-v3",
    "coffee-pull-v3",
    "coffee-push-v3",
    "dial-turn-v3",
    "disassemble-v3",
    "door-close-v3",
    "door-lock-v3",
    "door-open-v3",
    "door-unlock-v3",
    "hand-insert-v3",
    "drawer-close-v3",
    "drawer-open-v3",
    "faucet-open-v3",
    "faucet-close-v3",
    "hammer-v3",
    "handle-press-side-v3",
    "handle-press-v3",
    "handle-pull-side-v3",
    "handle-pull-v3",
    "lever-pull-v3",
    "pick-place-wall-v3",
    "pick-out-of-hole-v3",
    "pick-place-v3",
    "plate-slide-v3",
    "plate-slide-side-v3",
    "plate-slide-back-v3",
    "plate-slide-back-side-v3",
    "peg-insert-side-v3",
    "peg-unplug-side-v3",
    "soccer-v3",
    "stick-push-v3",
    "stick-pull-v3",
    "push-v3",
    "push-wall-v3",
    "push-back-v3",
    "reach-v3",
    "reach-wall-v3",
    "shelf-place-v3",
    "sweep-into-v3",
    "sweep-v3",
    "window-open-v3",
    "window-close-v3",
]

TASK_ID = {name: i for i, name in enumerate(ALL_V3_ENVIRONMENTS)}

_MAKERS: dict[str, Callable[[int], TaskSpec]] = {}
_SPECS: dict[str, TaskSpec] = {}


def register(name: str):
    assert name in TASK_ID, f"unknown env name {name}"

    def deco(make_spec: Callable[[int], TaskSpec]):
        _MAKERS[name] = make_spec
        return make_spec

    return deco


def _module_for(name: str) -> str:
    return "metaworld_tpu_torch.envs.tasks." + name.replace("-", "_")


def get_spec(name: str, reward_function_version: str = "v2") -> TaskSpec:
    """Task spec for `name` (v2 reward family)."""
    if name not in TASK_ID:
        raise KeyError(
            f"unknown env name {name!r}; valid names are the 50 entries of "
            "metaworld_tpu_torch.envs.registry.ALL_V3_ENVIRONMENTS"
        )
    if name not in _SPECS:
        if name not in _MAKERS:
            importlib.import_module(_module_for(name))
        _SPECS[name] = _MAKERS[name](TASK_ID[name])
    if reward_function_version != "v2":
        raise ValueError(
            "only the v2 reward family is ported; got "
            f"{reward_function_version!r}")
    return _SPECS[name]
