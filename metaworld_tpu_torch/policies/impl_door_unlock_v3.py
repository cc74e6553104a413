"""Scripted policy for door-unlock-v3 (ref policies/sawyer_door_unlock_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("door-unlock-v3")
def door_unlock_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    lock = o["obj1_pos"] + const(obs, -0.04, -0.02, -0.03)
    off_xy = norm(hand[:, :2] - lock[:, :2]) > 0.02
    desired = select(
        (off_xy & (hand[:, 2] > 0.15), hand + const(obs, 0.0, -0.1, -0.1)),
        (off_xy, lock),
        default=lock + const(obs, 0.1, 0.0, 0.01),
    )
    return action(move(hand, desired, p=25.0), 1.0)
