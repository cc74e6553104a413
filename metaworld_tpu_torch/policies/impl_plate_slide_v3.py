"""Scripted policy for plate-slide-v3 (ref policies/sawyer_plate_slide_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("plate-slide-v3")
def plate_slide_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, 0.0, -0.055, 0.03)
    shelf_x = obs[:, -3]
    desired = select(
        (norm(hand[:, :2] - puck[:, :2]) > 0.03, puck + const(obs, 0.0, 0.0, 0.1)),
        (torch.abs(hand[:, 2] - puck[:, 2]) > 0.04, puck),
        default=vec3(shelf_x, 0.9, puck[:, 2]),
    )
    return action(move(hand, desired, p=10.0), -1.0)
