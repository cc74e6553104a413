"""Scripted policy for push-v3 (ref policies/sawyer_push_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("push-v3")
def push_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.0)
    xy_err = norm(hand[:, :2] - puck[:, :2])
    desired = select(
        (xy_err > 0.02, puck + const(obs, 0.0, 0.0, 0.2)),
        (torch.abs(hand[:, 2] - puck[:, 2]) > 0.04, puck + const(obs, 0.0, 0.0, 0.03)),
        default=o["goal_pos"],
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.02) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.10)
    grab = torch.where(far, 0.0, 0.6)
    return action(move(hand, desired, p=10.0), grab)
