"""Scripted policy for hand-insert-v3 (ref policies/sawyer_hand_insert_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("hand-insert-v3")
def hand_insert_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    obj = o["obj1_pos"]
    goal = o["goal_pos"]
    obj_xy = norm(hand[:, :2] - obj[:, :2])
    obj_z = torch.abs(hand[:, 2] - obj[:, 2])
    desired = select(
        (obj_xy > 0.02, obj + const(obs, 0.0, 0.0, 0.1)),
        (obj_z > 0.05, obj + const(obs, 0.0, 0.0, 0.03)),
        (norm(hand[:, :2] - goal[:, :2]) > 0.04,
         const(obs, 1.0, 1.0, 0.0) * goal + const(obs, 0.0, 0.0, 1.0) * hand[:, 2:]),
        default=goal,
    )
    far = (obj_xy > 0.02) | (obj_z > 0.1)
    grab = torch.where(far, 0.0, 0.65)
    return action(move(hand, desired, p=10.0), grab)
