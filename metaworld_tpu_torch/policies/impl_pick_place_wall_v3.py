"""Scripted policy for pick-place-wall-v3 (ref policies/sawyer_pick_place_wall_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("pick-place-wall-v3")
def pick_place_wall_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.0)
    goal = o["goal_pos"]

    in_zone = ((-0.15 <= hand[:, 0]) & (hand[:, 0] <= 0.35)
               & (0.60 <= hand[:, 1]) & (hand[:, 1] <= 0.80))
    goal_leg = select(
        (in_zone & (hand[:, 2] < 0.25), hand + const(obs, 0.0, 0.0, 1.0)),
        (in_zone & (hand[:, 2] < 0.35),
         const(obs, 1.0, 1.0, 0.0) * goal + const(obs, 0.0, 0.0, 1.0) * hand[:, 2:]),
        (torch.abs(hand[:, 2] - goal[:, 2]) > 0.01,
         const(obs, 1.0, 1.0, 0.0) * hand + const(obs, 0.0, 0.0, 1.0) * goal[:, 2:]),
        default=goal,
    )
    desired = select(
        (norm(hand[:, :2] - puck[:, :2]) > 0.015, puck + const(obs, 0.0, 0.0, 0.1)),
        ((torch.abs(hand[:, 2] - puck[:, 2]) > 0.04) & (puck[:, 2] < 0.03),
         puck + const(obs, 0.0, 0.0, 0.03)),
        default=goal_leg,
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.015) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.1)
    grab = torch.where(far, 0.0, 0.9)
    return action(move(hand, desired, p=10.0), grab)
