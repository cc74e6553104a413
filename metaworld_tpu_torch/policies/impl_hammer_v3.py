"""Scripted policy for hammer-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("hammer-v3")
def hammer_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, -0.04, 0.0, -0.01)
    goal = (const(obs, 0.24, 0.71, 0.11) + const(obs, -0.19, 0.0, 0.05)).expand_as(hand)
    puck_xy = norm(hand[:, :2] - puck[:, :2])
    puck_z = torch.abs(hand[:, 2] - puck[:, 2])
    desired = select(
        (puck_xy > 0.04, puck + const(obs, 0.0, 0.0, 0.1)),
        ((puck_z > 0.05) & (puck[:, 2] < 0.03), puck + const(obs, 0.0, 0.0, 0.03)),
        (norm(hand[:, 0::2] - goal[:, 0::2]) > 0.02, vec3(goal[:, 0], hand[:, 1], goal[:, 2])),
        default=goal,
    )
    far = (puck_xy > 0.04) | (puck_z > 0.1)
    grab = torch.where(far, 0.0, 0.8)
    return action(move(hand, desired, p=10.0), grab)
