"""Scripted policy for shelf-place-v3 (ref policies/sawyer_shelf_place_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("shelf-place-v3")
def shelf_place_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    block = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.015)
    shelf_x = obs[:, -3]

    desired = select(
        (norm(hand[:, :2] - block[:, :2]) > 0.04, block + const(obs, 0.0, 0.0, 0.3)),
        (torch.abs(hand[:, 2] - block[:, 2]) > 0.04, block),
        (torch.abs(hand[:, 0] - shelf_x) > 0.02, vec3(shelf_x, hand[:, 1], 0.3)),
        (hand[:, 2] < 0.30, hand + const(obs, 0.0, 0.0, 0.30)),
        default=hand + const(obs, 0.0, 0.05, 0.0),
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.04) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.15)
    grab = torch.where(far, -1.0, 0.7)
    return action(move(hand, desired, p=25.0), grab)
