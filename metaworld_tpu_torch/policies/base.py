"""Scripted-policy base helpers, batched over the rows of (n, 39)
observations (counterpart of `metaworld_tpu/policies/base.py`).

A policy is a plain function obs (n, 39) -> action (n, 4), branchless:
`torch.where` cascades replace the reference's if/elif state machines
(ref metaworld/policies/policy.py:33-83, action.py:9-39), so one call acts
for every slot of a task. Constant vectors come from a per-device cache
(`const`) and scalars enter as Python numbers, so after its first call on
a device a policy makes no host-to-device copy and never synchronises
with the device.
"""

from __future__ import annotations

import torch

from metaworld_tpu_torch.physics.maths import norm_fma as norm  # noqa: F401

# (device, values) -> (1, k) float32 constant row, made on the first call
# per device and reused after it
_CONSTS: dict = {}


def const(like: torch.Tensor, *values: float) -> torch.Tensor:
    """(1, k) float32 constant row on `like`'s device (jnp.array([...])),
    which broadcasts against (n, k) rows."""
    key = (like.device, values)
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):  # a normal tensor, reusable by autograd
            t = _CONSTS[key] = torch.tensor([values], dtype=torch.float32,
                                            device=like.device)
    return t


def move(from_xyz, to_xyz, p):
    """P-controller response (ref policy.py:33-53); the env clips to [-1,1]."""
    return p * (to_xyz - from_xyz)


def action(delta_pos, grab_effort):
    """(n, 4) from the (n, 3) move and a grab effort, (n,) or a number."""
    if isinstance(grab_effort, torch.Tensor):
        grab = grab_effort[:, None]
    else:
        grab = torch.full_like(delta_pos[:, :1], float(grab_effort))
    return torch.cat([delta_pos, grab], dim=1)


def parse_obs(obs):
    """Standard column slices of the (n, 39) observations."""
    return {
        "hand_pos": obs[:, :3],
        "gripper": obs[:, 3],
        "obj1_pos": obs[:, 4:7],
        "obj1_quat": obs[:, 7:11],
        "obj2_pos": obs[:, 11:14],
        "obj2_quat": obs[:, 14:18],
        "goal_pos": obs[:, -3:],
    }


def select(*cases, default):
    """Branchless if/elif cascade: cases are (condition, value) pairs
    evaluated top-down like the reference's python if-chains. Conditions
    are (n,); values are (n, k) or (1, k) vectors, (n,) lanes or numbers."""
    out = default
    for cond, value in reversed(cases):
        if any(isinstance(v, torch.Tensor) and v.dim() == 2 for v in (value, out)):
            cond = cond[:, None]
        out = torch.where(cond, value, out)
    return out
