"""Scripted policy for soccer-v3 (ref policies/sawyer_soccer_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("soccer-v3")
def soccer_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    ball = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.03)
    goal = o["goal_pos"]

    desired_z = torch.where(norm(hand[:, :2] - ball[:, :2]) < 0.02, 0.1, 0.03)
    left = ball[:, 0] - goal[:, 0] < -0.05
    right = ball[:, 0] - goal[:, 0] > 0.05
    offset = 0.03
    push = select(
        (left, ball + const(obs, -offset, 0.0, 0.0)),
        (right, ball + const(obs, offset, 0.0, 0.0)),
        default=ball + const(obs, 0.0, -offset, 0.0),
    )
    push = vec3(push[:, 0], push[:, 1], desired_z)
    desired = select(
        (norm(hand - push) > 0.01, push),
        default=ball,
    )
    return action(move(hand, desired, p=25.0), 1.0)
