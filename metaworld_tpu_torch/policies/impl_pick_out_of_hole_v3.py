"""Scripted policy for pick-out-of-hole-v3 (ref policies/sawyer_pick_out_of_hole_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("pick-out-of-hole-v3")
def pick_out_of_hole_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.02)
    goal = o["goal_pos"]
    puck_xy = norm(hand[:, :2] - puck[:, :2])
    puck_z = torch.abs(hand[:, 2] - puck[:, 2])
    desired = select(
        (puck_xy > 0.02, puck + const(obs, 0.0, 0.0, 0.15)),
        (puck_z > 0.01, puck),
        (torch.abs(hand[:, 2] - goal[:, 2]) > 0.04,
         const(obs, 1.0, 1.0, 0.0) * hand + const(obs, 0.0, 0.0, 1.0) * goal[:, 2:]),
        default=goal,
    )
    far = (puck_xy > 0.02) | (puck_z > 0.15)
    grab = torch.where(far, 0.0, 0.1)
    return action(move(hand, desired, p=25.0), grab)
