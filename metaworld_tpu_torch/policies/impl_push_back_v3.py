"""Scripted policy for push-back-v3 (ref policies/sawyer_push_back_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("push-back-v3")
def push_back_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"]
    xy_err = norm(hand[:, :2] - puck[:, :2])
    z_err = torch.abs(hand[:, 2] - puck[:, 2])
    desired = select(
        (xy_err > 0.04, puck + const(obs, 0.0, 0.0, 0.3)),
        (z_err > 0.055, puck),
        default=o["goal_pos"] + const(obs, 0.0, 0.0, 1.0) * hand[:, 2:],
    )
    far = (xy_err > 0.04) | (z_err > 0.05)
    grab = torch.where(far, 0.0, 0.9)
    return action(move(hand, desired, p=10.0), grab)
