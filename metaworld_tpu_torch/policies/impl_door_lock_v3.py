"""Scripted policy for door-lock-v3 (ref policies/sawyer_door_lock_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("door-lock-v3")
def door_lock_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    lock = o["obj1_pos"] + const(obs, -0.02, -0.02, 0.0)
    off_xy = norm(hand[:, :2] - lock[:, :2]) > 0.02
    desired = select(
        (off_xy & (hand[:, 2] < 0.25), hand + const(obs, 0.0, -0.1, 0.1)),
        (off_xy, lock + const(obs, 0.0, 0.0, 0.3)),
        (torch.abs(hand[:, 2] - lock[:, 2]) > 0.02, lock),
        default=lock + const(obs, -0.1, 0.0, -0.1),
    )
    return action(move(hand, desired, p=25.0), -1.0)
