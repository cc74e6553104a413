"""Scripted expert policies, batched (counterpart of
`metaworld_tpu/policies/__init__.py`).

Each policy is a plain function obs (n, 39) -> action (n, 4) on the
observations' device, registered lazily per task module under
metaworld_tpu_torch/policies/impl_*.py. The experts have no parameters, so
`convert` carries nothing for them.
"""

from __future__ import annotations

import importlib
from typing import Callable

_POLICIES: dict[str, Callable] = {}


def register_policy(name: str):
    def deco(fn):
        _POLICIES[name] = fn
        return fn

    return deco


def get_policy(name: str) -> Callable:
    if name not in _POLICIES:
        mod = "metaworld_tpu_torch.policies.impl_" + name.replace("-", "_")
        importlib.import_module(mod)
    return _POLICIES[name]


def implemented_policies() -> list[str]:
    from metaworld_tpu_torch.envs.registry import ALL_V3_ENVIRONMENTS

    out = []
    for name in ALL_V3_ENVIRONMENTS:
        try:
            get_policy(name)
            out.append(name)
        except (ImportError, KeyError, ModuleNotFoundError):
            pass
    return out
