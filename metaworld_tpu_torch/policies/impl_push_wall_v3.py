"""Scripted policy for push-wall-v3 (ref policies/sawyer_push_wall_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("push-wall-v3")
def push_wall_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    obj = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.0)
    xy_err = norm(hand[:, :2] - obj[:, :2])

    x, y = obj[:, 0], obj[:, 1]
    wall_block = (-0.1 <= x) & (x <= 0.3) & (0.65 <= y) & (y <= 0.75)
    wall_side = (
        ((-0.15 < x) & (x < 0.05)) | ((0.15 < x) & (x < 0.35))
    ) & (0.695 <= y) & (y <= 0.755)
    goal_leg = select(
        (wall_block, hand + const(obs, -1.0, 0.0, 0.0)),
        (wall_side, hand + const(obs, 0.0, 1.0, 0.0)),
        default=o["goal_pos"],
    )
    desired = select(
        (xy_err > 0.02, obj + const(obs, 0.0, 0.0, 0.2)),
        (torch.abs(hand[:, 2] - obj[:, 2]) > 0.04, obj + const(obs, 0.0, 0.0, 0.03)),
        default=goal_leg,
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.02) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.1)
    grab = torch.where(far, 0.0, 0.6)
    return action(move(hand, desired, p=10.0), grab)
